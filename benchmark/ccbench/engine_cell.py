"""The engine a cell measures. It is built as a deployment builds it, on a model
directory without checkpoints, so every model is made on the device at
set-up; each family the configuration names (``families/<name>.py``) then
writes its models' weights, drawn from the seed, over the program's draw.
A model that no family of the configuration covers keeps the program's
draw. The traffic mix's kind (``kinds/<kind>.py``) drives the engine."""

from __future__ import annotations

import os
from typing import Dict

import torch


class EngineCell:
    def __init__(self, config: dict, families: Dict[str, object],
                 device: torch.device, tmp: str):
        from clearconverse_tpu_torch.config import Config, TorchConfig
        from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine
        self.device, self.tmp, self.config = device, tmp, config
        self.families = families
        # {family: its widths in the configuration}
        self.dims = {name: fam.dims(config) for name, fam in families.items()}
        model_dir = os.path.join(tmp, "models")
        os.makedirs(model_dir, exist_ok=True)
        eng = config["engine"]
        self.engine = TranscriptionEngine(
            Config(whisper_model_size=config["program_model"], **eng["Config"]),
            TorchConfig(**eng["TorchConfig"]), model_dir=model_dir,
            load_models_immediately=True, device=device)
        if not self.engine.models_are_loaded():
            raise RuntimeError("the engine failed to load its models")
        for name, fam in families.items():
            got = fam.program_dims(self.engine)
            if got != self.dims[name]:
                raise RuntimeError(
                    f"the program's models of family {name!r} are not the "
                    f"configuration's: {got} != {self.dims[name]}")

    def load_seed(self, seed: int) -> None:
        """Every family's weights for the seed into the program."""
        for name, fam in self.families.items():
            fam.fill(self.engine, fam.draw(self.dims[name], seed, self.device))

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
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

