"""Family ``whisper``: the program's Whisper (``models/whisper.py``) and
its decode program (``models/decoding.py``), checked against the plain
float32 Whisper of ``ccbench/reference.py``.

Weights: a Whisper of the configuration's widths under openai-whisper's
names, drawn from the seed (``ccbench/weights.py``) and written over the
program's draw, in the types they are served in (bfloat16, layer norms
float32); the reference reads the same draw widened to float32.

The check: for each decode call kept from the window, the reference
recomputes, from the audio rows that call encoded and the prompts it was
given, the log-probability of every token the program served (log-mel,
encoder, cross-attention over the whole audio, prefill and each loop step,
teacher-forced along the served tokens), and sums it per row as the
program's decode does. Two numbers: ``logprob_gap``, the widest gap,
over every row of every kept call, between the program's sum (the
``sum_logprob`` its decode returned) and the reference's, in nats, which a
single wrong token moves; and ``logprob_gap_mean``, that gap a token
averaged over the rows, which is steady from seed to seed. Sampled tokens
are fine: the sum is a function of the logits along the tokens served.
The control: the reference with fp8 operands, one precision below the
configuration's bfloat16, in the program's place.

``run_fields`` gives the per-layer metrics ``run["dims"]`` (these widths)
and ``run["decode_calls"]`` (unique rows, prompt lengths and loop steps
of every decode call in the window).
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ccbench.record import Keeper, Patch
from ccbench.reference import served_logprob_sums
from ccbench.weights import (fill_module, make_weights, reference_weights,
                             whisper_spec)

# The check's sample of decode calls: check.check_rng(seed, STREAM).
STREAM = 7

# The configuration's widths, under the published config.json names.
DIM_KEYS = ("num_mel_bins", "vocab_size", "max_source_positions",
            "max_target_positions", "d_model", "encoder_attention_heads",
            "encoder_layers", "decoder_attention_heads", "decoder_layers",
            "encoder_ffn_dim", "decoder_ffn_dim")


def dims(config: dict) -> dict:
    """The configuration's widths, under the published config.json names."""
    return {k: config[k] for k in DIM_KEYS}


def _published(wd) -> dict:
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


def program_dims(engine) -> dict:
    """The program's Whisper widths, under the same names."""
    return _published(engine.models._whisper[1])


def draw(dims: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's Whisper in the types it is served in."""
    return make_weights(whisper_spec(dims), seed, device)


def fill(engine, weights: Dict[str, torch.Tensor]) -> None:
    fill_module(engine.models._whisper[0], weights)


class DecodeRecorder:
    """Wraps ``models.decoding.greedy_decode_from_audio`` (which the store
    path calls too). While ``active``, each call leaves a light record
    (unique rows, prompt lengths, the packed result) and may be kept whole
    for the check: the call with the most prompt rows, and ``sample``
    others by reservoir sampling from ``rng``."""

    def __init__(self, rng: np.random.Generator, sample: int = 2):
        self.keep = Keeper(rng, sample)
        self.active = False
        self.light: List[dict] = []
        self.fault: Optional[Callable] = None
        from clearconverse_tpu_torch.models import decoding
        sig = inspect.signature(decoding.greedy_decode_from_audio)

        def make(orig):
            def wrapped(*args, **kwargs):
                out = orig(*args, **kwargs)
                if self.fault is not None:
                    out = self.fault(out)
                if self.active:
                    a = sig.bind(*args, **kwargs)
                    a.apply_defaults()
                    self._record(a.arguments, out)
                return out
            return wrapped

        self._patch = Patch(decoding, "greedy_decode_from_audio", make)

    def _record(self, a: dict, out: dict) -> None:
        opts = a["opts"]
        rec = {"audio": a["audio"], "prompts": a["prompt_tokens"],
               "prompt_lens": a["prompt_lens"], "packed": out["packed"],
               "target_len": a["target_len"], "replicas": opts.replicas,
               "max_tokens": opts.max_tokens, "eot": opts.eot,
               "blank": opts.blank_token, "suppress_blank": opts.suppress_blank,
               "suppress": tuple(opts.suppress_tokens),
               "timestamp_begin": (opts.timestamp_begin if opts.timestamps
                                   else -1),
               "beam": bool(opts.beam and opts.replicas > 1)}
        self.light.append({k: rec[k] for k in
                           ("audio", "prompt_lens", "packed", "max_tokens")})
        self.light[-1]["audio"] = tuple(rec["audio"].shape)
        self.keep.offer(rec, rec["prompts"].shape[0])

    def kept(self) -> List[dict]:
        return self.keep.kept()

    def rows_and_steps(self):
        """[(unique rows, prompt lengths, loop steps)] per recorded call;
        the loop ran until every row's EOT or max_tokens - 1 steps."""
        out = []
        for r in self.light:
            pk = r["packed"].cpu().numpy()
            mt = r["max_tokens"]
            steps = int(min(int(pk[:, mt].max()), mt - 1))
            out.append((r["audio"][0], r["prompt_lens"].cpu().numpy(), steps))
        return out

    def remove(self) -> None:
        self._patch.remove()


def recorder(rng: np.random.Generator, sample: int) -> DecodeRecorder:
    return DecodeRecorder(rng, sample)


def run_fields(recorder: DecodeRecorder, dims: dict) -> dict:
    return {"dims": dims, "decode_calls": recorder.rows_and_steps()}


def _unpack(packed: torch.Tensor, mt: int):
    pk = packed.detach().cpu()
    return (pk[:, :mt].clone(), pk[:, mt].clone(),
            pk[:, mt + 1].clone().view(torch.float32).double().numpy())


def whisper_readings(kept: List[dict], dims: dict,
                     weights: Dict[str, torch.Tensor],
                     control: bool = False) -> dict:
    """{"numbers": {"logprob_gap", "logprob_gap_mean"}, "control": the
    same for the fp8 reference (with ``control``), "rows", "tokens"}."""
    out = {"numbers": {}, "control": {}, "rows": 0, "tokens": 0}
    if not kept:
        return out
    gaps, per_tok, low_gaps, low_per_tok = [], [], [], []
    for rec in kept:
        if rec["beam"]:
            raise ValueError("beam decodes carry beam scores, not sums of "
                             "the served tokens' log-probabilities")
        if rec["timestamp_begin"] >= 0:
            raise ValueError("timestamp decodes are not scored here")
        mt = rec["max_tokens"]
        toks, lens, slp = _unpack(rec["packed"], mt)
        n_tok = torch.clamp(lens + 1, max=mt).double().numpy()
        dev = rec["audio"].device
        kw = dict(w=weights, dims=dims, audio=rec["audio"],
                  prompts=rec["prompts"].to(dev),
                  prompt_lens=rec["prompt_lens"].to(dev),
                  tokens=toks.to(dev), lengths=lens.to(dev),
                  replicas=rec["replicas"], suppress=rec["suppress"],
                  blank=rec["blank"], eot=rec["eot"],
                  suppress_blank=rec["suppress_blank"], max_tokens=mt,
                  target_len=rec["target_len"])
        ref = served_logprob_sums(**kw)
        gaps.append(np.abs(slp - ref))
        per_tok.append(gaps[-1] / n_tok)
        if control:
            low_gaps.append(np.abs(served_logprob_sums(fp8=True, **kw) - ref))
            low_per_tok.append(low_gaps[-1] / n_tok)
        out["rows"] += len(slp)
        out["tokens"] += int(n_tok.sum())
    out["numbers"] = {"logprob_gap": float(np.concatenate(gaps).max()),
                      "logprob_gap_mean": float(np.concatenate(per_tok).mean())}
    if control:
        out["control"] = {
            "logprob_gap": float(np.concatenate(low_gaps).max()),
            "logprob_gap_mean": float(np.concatenate(low_per_tok).mean())}
    return out


def readings(recorder: DecodeRecorder, dims: dict, seed: int, device,
             control: bool) -> dict:
    """The kept decode calls against the reference, on the seed's weights
    drawn anew in float32."""
    w = whisper_readings(recorder.kept(), dims,
                         reference_weights(whisper_spec(dims), seed, device),
                         control)
    return {"numbers": w["numbers"], "control": w["control"],
            "counts": {"rows": w["rows"], "tokens": w["tokens"]}}


def altered_token(out: dict) -> dict:
    """The second served token of every row replaced where the decode
    produced it (a text token, never EOT)."""
    packed = out["packed"].clone()
    tok = packed[:, 1]
    packed[:, 1] = torch.where(tok == 1000, 1001, 1000).to(packed.dtype)
    return {**out, "packed": packed}


FAULTS = {"altered_token": ("decode", altered_token)}
