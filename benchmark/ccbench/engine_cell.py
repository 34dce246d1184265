"""The engine a cell measures. It is built as a deployment builds it, on a model
directory without checkpoints, so every family is made on the device at
set-up; the benchmark then writes its own Whisper, PyanNet and ECAPA
weights, drawn from the seed, over the program's draw (``weights.py``).
RE-SepFormer, which no batch cell reaches, keeps the program's draw.
The traffic mix's kind (``kinds/<kind>.py``) drives the engine."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ccbench.weights import (fill_module, fill_tree, make_weights,
                             speaker_weights, whisper_spec)

# The configuration's widths, under the published config.json names.
DIM_KEYS = ("num_mel_bins", "vocab_size", "max_source_positions",
            "max_target_positions", "d_model", "encoder_attention_heads",
            "encoder_layers", "decoder_attention_heads", "decoder_layers",
            "encoder_ffn_dim", "decoder_ffn_dim")


def program_dims(wd) -> dict:
    """The program's WhisperDims under the published names."""
    return {"num_mel_bins": wd.n_mels, "vocab_size": wd.n_vocab,
            "max_source_positions": wd.n_audio_ctx,
            "max_target_positions": wd.n_text_ctx,
            "d_model": wd.n_audio_state,
            "encoder_attention_heads": wd.n_audio_head,
            "encoder_layers": wd.n_audio_layer,
            "decoder_attention_heads": wd.n_text_head,
            "decoder_layers": wd.n_text_layer,
            "encoder_ffn_dim": 4 * wd.n_audio_state,
            "decoder_ffn_dim": 4 * wd.n_text_state}


def program_speaker_dims(bundle) -> dict:
    """The program's PyanNet and ECAPA widths, as the configuration lists
    them."""
    from clearconverse_tpu_torch.models.ecapa import EcapaDims
    from clearconverse_tpu_torch.models.pyannet import PyannetDims

    def plain(dims):
        return {k: list(v) if isinstance(v, tuple) else v
                for k, v in dataclasses.asdict(dims).items()}

    return {"pyannet": plain(bundle._pyannet_dims or PyannetDims()),
            "ecapa": plain(bundle._ecapa_dims or EcapaDims())}


class EngineCell:
    def __init__(self, config: dict, device: torch.device, tmp: str):
        from clearconverse_tpu_torch.config import Config, TorchConfig
        from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine
        self.device, self.tmp, self.config = device, tmp, config
        self.dims = {k: config[k] for k in DIM_KEYS}
        model_dir = os.path.join(tmp, "models")
        os.makedirs(model_dir, exist_ok=True)
        eng = config["engine"]
        self.engine = TranscriptionEngine(
            Config(whisper_model_size=config["program_model"], **eng["Config"]),
            TorchConfig(**eng["TorchConfig"]), model_dir=model_dir,
            load_models_immediately=True, device=device)
        if not self.engine.models_are_loaded():
            raise RuntimeError("the engine failed to load its models")
        model, wd, _tok = self.engine.models._whisper
        got = program_dims(wd)
        if got != self.dims:
            raise RuntimeError(f"the program's Whisper is not the "
                               f"configuration's: {got} != {self.dims}")
        bundle = self.engine.models
        self.speaker_dims = {k: config[k] for k in ("pyannet", "ecapa")}
        got = program_speaker_dims(bundle)
        if got != self.speaker_dims:
            raise RuntimeError(f"the program's speaker models are not the "
                               f"configuration's: {got} != {self.speaker_dims}")
        self.model = model
        self.spec = whisper_spec(self.dims)

    def load_seed(self, seed: int) -> None:
        """The seed's Whisper, PyanNet and ECAPA weights into the program."""
        fill_module(self.model, make_weights(self.spec, seed, self.device))
        bundle = self.engine.models
        sw = speaker_weights(self.speaker_dims, seed, self.device)
        fill_tree(bundle._pyannet, sw["pyannet"])
        fill_tree(bundle._ecapa, sw["ecapa"])

    def inputs_dir(self, seed: int) -> str:
        out = os.path.join(self.tmp, f"traffic_{seed}")
        os.makedirs(out, exist_ok=True)
        return out

    def traced(self, unit, kernels) -> dict:
        """``unit()``, one unit of the mix's work, once under the profiler
        (kernel time by name, busy and idle time, the K1 and K2 shapes it
        launched), then once with the decode program's synchronising spans
        (the token loop's time a step)."""
        from clearconverse_tpu_torch.utils.tracing import StageTimer
        from ccbench.trace import traced
        kernels.reset()
        kernels.active = True
        _, trace = traced(unit, self.device)
        kernels.active = False
        timer = StageTimer(sync=True)
        self.engine.models.decode_timer = timer
        try:
            unit()
        finally:
            self.engine.models.decode_timer = None
        return {"trace": trace, "k1_traced": list(kernels.k1),
                "k2_traced": list(kernels.k2), "decode_timer": timer}

    def close(self) -> None:
        """Frees the program's state before the reference runs."""
        self.engine = None
        self.model = None
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def check_rng(seed: int, stream: int = 7) -> np.random.Generator:
    """The sample of calls kept for the check, drawn from the seed."""
    return np.random.default_rng([seed % (1 << 63), stream])
