"""Family ``resepformer``: the program's overlap separator
(``models/resepformer.py``, ``TorchConfig.separator =
"resepformer-wsj02mix"``), checked against the plain float32 RE-SepFormer
of ``ccbench/resepformer_reference.py``.

Weights: the published layout at the configuration's widths (its
``resepformer`` section, the recipe's names) under the names of the
program's module, drawn on the card from the seed in a stream of their
own and served in float32, written over the program's draw: matrices and
kernels normal with std fan_in^-0.5, biases std 0.02, LayerNorm and gLN
gains 1 + N(0, 0.1^2) and offsets N(0, 0.02^2), the PReLU slope 0.25.

The check: for each ``sepformer_separate`` call kept (the one with the
most rows and ``check_calls - 1`` drawn from the seed), the reference
separates every row that has an encoder frame alone, at its own length.
``sep_gap`` is the widest ‖program − reference‖ / ‖reference‖ of any kept
row's source, over the row's real samples. The control: the reference at
TF32, one precision below the configuration's float32, in the program's
place.

``run_fields`` gives the per-layer metrics ``run["separation_calls"]``
(rows, padded length and the lengths of every call in the window) and
``run["resepformer_dims"]`` (these widths).
"""

from __future__ import annotations

import inspect
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ccbench.record import Keeper, Patch
from ccbench.resepformer_reference import separate_one

# The check's sample of separation calls: check.check_rng(seed, STREAM).
STREAM = 9
# The weights' stream: past those of ccbench.weights.STREAM.
WEIGHT_STREAM = 3 << 40

# What the program's ResepformerDims fixes and the recipe names.
LAYOUT = {"mem_type": "av", "activation": "relu", "norm_before": True,
          "use_positional_encoding": True, "nonlinear": "relu"}
WIDTHS = ("N_encoder_out", "out_channels", "kernel_size", "kernel_stride",
          "num_spks", "segment_size", "layer", "num_layers", "nhead", "d_ffn")


def dims(config: dict) -> dict:
    """The configuration's ``resepformer`` section, its widths and
    layout."""
    sec = config["resepformer"]
    return {k: sec[k] for k in WIDTHS + tuple(LAYOUT)}


def program_dims(engine) -> dict:
    """The program's separator under the same names (its class name when
    it is not the published layout)."""
    from clearconverse_tpu_torch.models import resepformer as rsf
    sep = engine.models._sepformer
    if not isinstance(sep, rsf.Resepformer):
        return {"separator": type(sep).__name__}
    d = sep.dims
    return {"N_encoder_out": d.enc_channels, "out_channels": d.d_model,
            "kernel_size": d.enc_kernel, "kernel_stride": d.enc_stride,
            "num_spks": d.n_sources, "segment_size": d.segment_size,
            "layer": d.n_blocks, "num_layers": d.n_layers,
            "nhead": d.n_heads, "d_ffn": d.d_ffn, **LAYOUT}


def spec(d: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every weight, under the program's names."""
    N, w, f, L = (d["N_encoder_out"], d["out_channels"], d["d_ffn"],
                  d["kernel_size"])
    out = [("encoder.conv1d.weight", (N, 1, L), "conv")]

    def block(p: str) -> None:
        for j in range(d["num_layers"]):
            q = f"{p}.mdl.layers.{j}"
            out.extend([
                (f"{q}.self_att.att.in_proj_weight", (3 * w, w), "linear"),
                (f"{q}.self_att.att.in_proj_bias", (3 * w,), "bias"),
                (f"{q}.self_att.att.out_proj.weight", (w, w), "linear"),
                (f"{q}.self_att.att.out_proj.bias", (w,), "bias"),
                (f"{q}.pos_ffn.ffn.0.weight", (f, w), "linear"),
                (f"{q}.pos_ffn.ffn.0.bias", (f,), "bias"),
                (f"{q}.pos_ffn.ffn.3.weight", (w, f), "linear"),
                (f"{q}.pos_ffn.ffn.3.bias", (w,), "bias")])
            for n in ("norm1", "norm2"):
                out.extend([(f"{q}.{n}.norm.weight", (w,), "gain"),
                            (f"{q}.{n}.norm.bias", (w,), "offset")])
        out.extend([(f"{p}.mdl.norm.norm.weight", (w,), "gain"),
                    (f"{p}.mdl.norm.norm.bias", (w,), "offset"),
                    (f"{p}.norm.weight", (w, 1), "gain"),
                    (f"{p}.norm.bias", (w, 1), "offset")])

    for i in range(d["layer"]):
        block(f"masknet.model.seg_model.{i}")
    for i in range(d["layer"] - 1):
        block(f"masknet.model.mem_model.{i}")
    spk = d["num_spks"]
    out.extend([("masknet.model.output_fc.0.weight", (1,), "prelu"),
                ("masknet.model.output_fc.1.weight", (spk * N, w, 1), "conv"),
                ("masknet.model.output_fc.1.bias", (spk * N,), "bias"),
                ("decoder.conv_tr.weight", (N, 1, L), "conv_tr")])
    return out


def draw(dims: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's separator, float32 on ``device``, from one draw."""
    sp = spec(dims)
    gen = torch.Generator(device=device).manual_seed(
        (seed + WEIGHT_STREAM) % (1 << 63))
    z = torch.randn(sum(math.prod(s) for _, s, _ in sp), generator=gen,
                    device=device)
    out, at = {}, 0
    for name, shape, kind in sp:
        n = math.prod(shape)
        v = z[at: at + n].view(shape)
        at += n
        if kind in ("linear", "conv"):
            v = v * (n // shape[0]) ** -0.5
        elif kind == "conv_tr":                 # [in, out, k]: fan-in is in
            v = v * shape[0] ** -0.5
        elif kind in ("bias", "offset"):
            v = v * 0.02
        elif kind == "gain":
            v = 1.0 + 0.1 * v
        elif kind == "prelu":
            v = torch.full(shape, 0.25, device=device)
        else:
            raise ValueError(f"unknown tensor kind {kind!r}")
        out[name] = v.float().clone()
    return out


def fill(engine, weights: Dict[str, torch.Tensor]) -> None:
    from ccbench.weights import fill_module
    fill_module(engine.models._sepformer, weights)


class SeparationRecorder:
    """Wraps ``models.resepformer.sepformer_separate``, which the program's
    bundle looks up at each call. While ``active``, each call leaves its
    rows, padded length and lengths, and may be kept whole for the check
    (the rows, lengths and sources it returned). ``fault`` breaks the
    output where it is produced."""

    def __init__(self, rng: np.random.Generator, sample: int = 2):
        from clearconverse_tpu_torch.models import resepformer
        self.active = False
        self.fault = None
        self.keep = Keeper(rng, sample)
        self.calls: List[Tuple[int, int, List[int]]] = []

        def make(orig):
            sig = inspect.signature(orig)

            def wrapped(*args, **kwargs):
                out = orig(*args, **kwargs)
                if self.fault is not None:
                    out = self.fault(out)
                if self.active:
                    a = sig.bind(*args, **kwargs)
                    a.apply_defaults()
                    mix = a.arguments["mix"]
                    B, T = mix.shape
                    lens = a.arguments["lengths"]
                    lens = ([T] * B if lens is None
                            else [int(n) for n in torch.as_tensor(lens).tolist()])
                    self.calls.append((B, T, lens))
                    self.keep.offer({"mix": mix, "lengths": lens, "out": out}, B)
                return out
            return wrapped

        self._patch = Patch(resepformer, "sepformer_separate", make)

    def kept(self) -> List[dict]:
        return self.keep.kept()

    def remove(self) -> None:
        self._patch.remove()


def recorder(rng: np.random.Generator, sample: int) -> SeparationRecorder:
    return SeparationRecorder(rng, sample)


def run_fields(recorder: SeparationRecorder, dims: dict) -> dict:
    return {"separation_calls": list(recorder.calls),
            "resepformer_dims": dims}


def _gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest ‖got − ref‖ / ‖ref‖ over the sources ([T, sources])."""
    d = (got.double() - ref.double()).norm(dim=0)
    return float((d / ref.double().norm(dim=0).clamp_min(1e-30)).max())


def separation_readings(kept: List[dict], dims: dict,
                        weights: Dict[str, torch.Tensor],
                        control: bool = False) -> dict:
    """{"numbers": {"sep_gap"}, "control": the same for the TF32 reference
    (with ``control``), "sep_rows", "sep_samples"}."""
    out = {"numbers": {}, "control": {}, "sep_rows": 0, "sep_samples": 0}
    if not kept:
        return out
    worst = {False: 0.0, True: 0.0}
    for rec in kept:
        for r, n in enumerate(rec["lengths"]):
            if n < dims["kernel_size"]:
                continue                 # no frame: nothing to judge
            row = rec["mix"][r, :n]
            ref = separate_one(weights, dims, row)
            got = rec["out"][r, :n].to(ref.device)
            worst[False] = max(worst[False], _gap(got, ref))
            if control:
                low = separate_one(weights, dims, row, tf32=True)
                worst[True] = max(worst[True], _gap(low, ref))
            out["sep_rows"] += 1
            out["sep_samples"] += n
    out["numbers"]["sep_gap"] = worst[False]
    if control:
        out["control"]["sep_gap"] = worst[True]
    return out


def readings(recorder: SeparationRecorder, dims: dict, seed: int, device,
             control: bool) -> dict:
    """The kept calls against the reference, on the seed's weights drawn
    anew."""
    s = separation_readings(recorder.kept(), dims, draw(dims, seed, device),
                            control)
    return {"numbers": s["numbers"], "control": s["control"],
            "counts": {"sep_rows": s["sep_rows"],
                       "sep_samples": s["sep_samples"]}}


def altered_source(out: torch.Tensor) -> torch.Tensor:
    """The first row's two sources swapped."""
    out = out.clone()
    out[0] = out[0].flip(-1)
    return out


FAULTS = {"altered_source": ("resepformer", altered_source)}
