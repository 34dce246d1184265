"""Family ``voxtral``: the program's Voxtral Mini 3B (``models/voxtral.py``,
``Config.whisper_model_size = "voxtral-mini-3b-2507"``) and its decode
(``models/decoding.voxtral_decode_from_audio``), checked against the plain
float32 Voxtral of ``ccbench/voxtral_reference.py``.

Weights: every tensor of the published layout at the configuration's
widths under HF's names (``audio_tower.*``, ``multi_modal_projector.*``,
``language_model.*``), drawn on the card from the seed, one tensor after
another from one generator of the family's own stream, in the types they
are served in (bfloat16; layer norms and RMSNorm weights float32), and
written over the program's draw through the program's own HF loader
(``models/convert.load_voxtral_state_dict``); the reference reads the same
draw widened to float32. Matrices and convolutions normal with std
fan_in^-0.5, biases std 0.02, norm gains 1 + N(0, 0.1^2), layer-norm
offsets N(0, 0.02^2), token embeddings std d^-0.5, the encoder's fixed
sinusoid table.

The check: for each decode call kept from the window (the one with the
most rows and ``check_calls - 1`` drawn from the seed), the reference
recomputes, by a full forward with no cache, the log-probability of every
served token of the rows it checks, teacher-forced from that call's own
audio rows and prompt ids, and sums it per row as the decode does.
``logprob_gap``: the widest gap, over the rows checked, between the
program's ``sum_logprob`` and the reference's, in nats; ``logprob_gap_mean``:
that gap a token, averaged. Every row of a 160-row call at 128 tokens is
about 8 s of float32 work on the card, so the check takes a seeded sample
of each kept call: ``CHECKED_REPLICAS`` replicas of every unique row
(every unique row's audio and prefix is checked through at least one of its
replicas). The control: the reference with fp8 e4m3 operands, one
precision below the configuration's bfloat16, in the program's place.

``run_fields`` gives the per-layer metrics ``run["voxtral_dims"]`` (these
widths) and ``run["voxtral_calls"]`` (the counters of every decode call
in the window: unique rows, prefix positions, rows, loop steps, suffix
positions, prefix copies and prefix reads).
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ccbench.check import check_rng
from ccbench.record import Keeper, Patch
from ccbench.voxtral_reference import served_logprob_sums
from ccbench.weights import sinusoids

# The check's sample of decode calls: check.check_rng(seed, STREAM); the
# rows checked of each kept call: check_rng(seed, ROW_STREAM).
STREAM = 10
ROW_STREAM = 11
# Replicas checked of every unique row of a kept call.
CHECKED_REPLICAS = 2
# The weights' stream: past those of ccbench.weights.STREAM and
# families/resepformer.WEIGHT_STREAM.
WEIGHT_STREAM = 4 << 40

AUDIO_KEYS = ("num_mel_bins", "hidden_size", "intermediate_size",
              "num_hidden_layers", "num_attention_heads",
              "max_source_positions")
TEXT_KEYS = ("hidden_size", "intermediate_size", "num_hidden_layers",
             "num_attention_heads", "num_key_value_heads", "head_dim",
             "vocab_size", "rms_norm_eps", "rope_theta")


def dims(config: dict) -> dict:
    """The configuration's audio and text widths, under HF's names."""
    return {"audio_config": {k: config["audio_config"][k] for k in AUDIO_KEYS},
            "text_config": {k: config["text_config"][k] for k in TEXT_KEYS}}


def program_dims(engine) -> dict:
    """The program's VoxtralDims under the same names (the transcriber's
    class name when it is not Voxtral)."""
    vox = getattr(engine.models, "_voxtral", None)
    if vox is None:
        return {"transcriber": "whisper"}
    d = vox[1]
    return {"audio_config": {
                "num_mel_bins": d.n_mels, "hidden_size": d.n_audio_state,
                "intermediate_size": 4 * d.n_audio_state,
                "num_hidden_layers": d.n_audio_layer,
                "num_attention_heads": d.n_audio_head,
                "max_source_positions": d.n_audio_ctx},
            "text_config": {
                "hidden_size": d.d_model, "intermediate_size": d.d_ffn,
                "num_hidden_layers": d.n_layer, "num_attention_heads": d.n_head,
                "num_key_value_heads": d.n_kv_head, "head_dim": d.head_dim,
                "vocab_size": d.n_vocab, "rms_norm_eps": d.rms_eps,
                "rope_theta": d.rope_theta}}


def spec(d: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(HF name, shape, kind) of every tensor."""
    a, t = d["audio_config"], d["text_config"]
    A, F, M = a["hidden_size"], a["intermediate_size"], a["num_mel_bins"]
    D, FF, V = t["hidden_size"], t["intermediate_size"], t["vocab_size"]
    Q = t["num_attention_heads"] * t["head_dim"]
    KV = t["num_key_value_heads"] * t["head_dim"]
    out = [("audio_tower.conv1.weight", (A, M, 3), "conv"),
           ("audio_tower.conv1.bias", (A,), "bias"),
           ("audio_tower.conv2.weight", (A, A, 3), "conv"),
           ("audio_tower.conv2.bias", (A,), "bias"),
           ("audio_tower.embed_positions.weight",
            (a["max_source_positions"], A), "sinusoid")]
    for i in range(a["num_hidden_layers"]):
        p = f"audio_tower.layers.{i}"
        for n in ("self_attn_layer_norm", "final_layer_norm"):
            out += [(f"{p}.{n}.weight", (A,), "ln_gain"),
                    (f"{p}.{n}.bias", (A,), "ln_bias")]
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out.append((f"{p}.self_attn.{n}.weight", (A, A), "linear"))
            if n != "k_proj":
                out.append((f"{p}.self_attn.{n}.bias", (A,), "bias"))
        out += [(f"{p}.fc1.weight", (F, A), "linear"), (f"{p}.fc1.bias", (F,), "bias"),
                (f"{p}.fc2.weight", (A, F), "linear"), (f"{p}.fc2.bias", (A,), "bias")]
    out += [("audio_tower.layer_norm.weight", (A,), "ln_gain"),
            ("audio_tower.layer_norm.bias", (A,), "ln_bias"),
            ("multi_modal_projector.linear_1.weight", (D, F), "linear"),
            ("multi_modal_projector.linear_2.weight", (D, D), "linear"),
            ("language_model.model.embed_tokens.weight", (V, D), "embed")]
    for i in range(t["num_hidden_layers"]):
        p = f"language_model.model.layers.{i}"
        out += [(f"{p}.input_layernorm.weight", (D,), "ln_gain"),
                (f"{p}.self_attn.q_proj.weight", (Q, D), "linear"),
                (f"{p}.self_attn.k_proj.weight", (KV, D), "linear"),
                (f"{p}.self_attn.v_proj.weight", (KV, D), "linear"),
                (f"{p}.self_attn.o_proj.weight", (D, Q), "linear"),
                (f"{p}.post_attention_layernorm.weight", (D,), "ln_gain"),
                (f"{p}.mlp.gate_proj.weight", (FF, D), "linear"),
                (f"{p}.mlp.up_proj.weight", (FF, D), "linear"),
                (f"{p}.mlp.down_proj.weight", (D, FF), "linear")]
    out += [("language_model.model.norm.weight", (D,), "ln_gain"),
            ("language_model.lm_head.weight", (V, D), "linear")]
    return out


def _draw(dims: dict, seed: int, device, served: bool) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(
        (seed + WEIGHT_STREAM) % (1 << 63))
    out = {}
    for name, shape, kind in spec(dims):
        if kind == "sinusoid":
            v = torch.from_numpy(sinusoids(*shape)).to(device)
        else:
            z = torch.randn(shape, generator=gen, device=device)
            if kind == "linear":
                v = z * shape[1] ** -0.5
            elif kind == "conv":
                v = z * (shape[1] * shape[2]) ** -0.5
            elif kind in ("bias", "ln_bias"):
                v = z * 0.02
            elif kind == "ln_gain":
                v = 1.0 + 0.1 * z
            elif kind == "embed":
                v = z * shape[1] ** -0.5
            else:
                raise ValueError(f"unknown tensor kind {kind!r}")
            del z
        v = v.to(torch.float32 if kind.startswith("ln_") else torch.bfloat16)
        out[name] = v if served else v.float()
    return out


def draw(dims: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's Voxtral in the types it is served in."""
    return _draw(dims, seed, device, served=True)


def reference_weights(dims: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The same draw, widened to float32."""
    return _draw(dims, seed, device, served=False)


def fill(engine, weights: Dict[str, torch.Tensor]) -> None:
    from clearconverse_tpu_torch.models.convert import load_voxtral_state_dict
    load_voxtral_state_dict(engine.models._voxtral[0], weights)


class DecodeRecorder:
    """Wraps ``models.decoding.voxtral_decode_from_audio``, which the
    bundle looks up at each call. While ``active``, each call leaves its
    counters and may be kept whole for the check (its audio, prompt ids,
    options and packed result): the call with the most rows, and
    ``sample`` others by reservoir sampling from ``rng``."""

    def __init__(self, rng: np.random.Generator, sample: int = 2):
        self.keep = Keeper(rng, sample)
        self.active = False
        self.calls: List[dict] = []
        self.fault: Optional[Callable] = None
        from clearconverse_tpu_torch.models import decoding
        sig = inspect.signature(decoding.voxtral_decode_from_audio)

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

        self._patch = Patch(decoding, "voxtral_decode_from_audio", make)

    def _record(self, a: dict, out: dict) -> None:
        opts = a["opts"]
        self.calls.append(dict(out["counts"]))
        rec = {"audio": a["audio"], "head": tuple(a["head"]),
               "tail": tuple(a["tail"]), "packed": out["packed"],
               "target_len": a["target_len"], "replicas": opts.replicas,
               "max_tokens": opts.max_tokens,
               "suppress": tuple(opts.suppress_tokens)}
        self.keep.offer(rec, a["audio"].shape[0] * opts.replicas)

    def kept(self) -> List[dict]:
        return self.keep.kept()

    def remove(self) -> None:
        self._patch.remove()


def recorder(rng: np.random.Generator, sample: int) -> DecodeRecorder:
    return DecodeRecorder(rng, sample)


def run_fields(recorder: DecodeRecorder, dims: dict) -> dict:
    return {"voxtral_dims": dims, "voxtral_calls": list(recorder.calls)}


def checked_rows(rng: np.random.Generator, U: int, R: int) -> List[int]:
    """``CHECKED_REPLICAS`` replicas (all when fewer) of each of U unique
    rows, drawn from ``rng``: indices into the call's U·R rows."""
    k = min(CHECKED_REPLICAS, R)
    return [u * R + int(r) for u in range(U)
            for r in sorted(rng.choice(R, size=k, replace=False))]


def voxtral_readings(kept: List[dict], dims: dict,
                     weights: Dict[str, torch.Tensor], rng: np.random.Generator,
                     control: bool = False) -> dict:
    """{"numbers": {"logprob_gap", "logprob_gap_mean"}, "control": the
    same for the fp8 reference (with ``control``), "rows", "tokens"}."""
    out = {"numbers": {}, "control": {}, "rows": 0, "tokens": 0}
    if not kept:
        return out
    gaps, per_tok, low_gaps, low_per_tok = [], [], [], []
    for rec in kept:
        mt, R = rec["max_tokens"], rec["replicas"]
        pk = rec["packed"].detach().cpu()
        toks, lens = pk[:, :mt].clone(), pk[:, mt].clone()
        slp = pk[:, mt + 1].clone().view(torch.float32).double().numpy()
        rows = checked_rows(rng, rec["audio"].shape[0], R)
        n_tok = torch.clamp(lens[rows] + 1, max=mt).double().numpy()
        kw = dict(w=weights, dims=dims, audio=rec["audio"], head=rec["head"],
                  tail=rec["tail"], tokens=toks, lengths=lens, rows=rows,
                  replicas=R, suppress=rec["suppress"], max_tokens=mt,
                  target_len=rec["target_len"])
        ref = served_logprob_sums(**kw)
        gaps.append(np.abs(slp[rows] - ref))
        per_tok.append(gaps[-1] / n_tok)
        if control:
            low_gaps.append(np.abs(served_logprob_sums(fp8=True, **kw) - ref))
            low_per_tok.append(low_gaps[-1] / n_tok)
        out["rows"] += len(rows)
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
    w = voxtral_readings(recorder.kept(), dims,
                         reference_weights(dims, seed, device),
                         check_rng(seed, ROW_STREAM), control)
    return {"numbers": w["numbers"], "control": w["control"],
            "counts": {"rows": w["rows"], "tokens": w["tokens"]}}


def altered_token(out: dict) -> dict:
    """The second served token of every row replaced where the decode
    produced it (a byte id, never a control id or EOS)."""
    packed = out["packed"].clone()
    tok = packed[:, 1]
    packed[:, 1] = torch.where(tok == 1000, 1001, 1000).to(packed.dtype)
    return {**out, "packed": packed}


FAULTS = {"altered_token": ("decode", altered_token)}
