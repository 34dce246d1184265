"""Family ``speakers``: the program's PyanNet (``models/pyannet.py``,
pyannote's segmentation) and ECAPA-TDNN (``models/ecapa.py``,
speechbrain's speaker embedding), checked against the plain float32
models of ``ccbench/speaker_reference.py``.

Weights: both models at the configuration's widths (its ``pyannet`` and
``ecapa`` sections) under the names of the program's weight trees, drawn
from the seed (``ccbench/weights.py``, a stream of each model's own) and
served in float32, written over the program's draw.

The check: for each PyanNet and ECAPA call kept, the reference
recomputes the output from the audio rows the call took.
``seg_logprob_gap`` is the widest gap of a powerset log-probability
(nats); ``embed_gap`` the widest distance of a row's embedding from the
reference's, over the reference's norm. Rows with no valid frame (the
padding of a batch, one sample long) have no embedding to judge. The
control: the reference at TF32, one precision below the configuration's
float32, in the program's place. Both models' samples are drawn from one
generator, in the order the calls come.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Dict, List

import numpy as np
import torch

from ccbench.record import Keeper, Patch
from ccbench.speaker_reference import ecapa_embeddings, pyannet_logprobs
from ccbench.weights import fill_tree, speaker_weights

# The check's sample of PyanNet and ECAPA calls: check.check_rng(seed, STREAM).
STREAM = 8
MODELS = ("pyannet", "ecapa")


def dims(config: dict) -> dict:
    """The configuration's ``pyannet`` and ``ecapa`` sections."""
    return {k: config[k] for k in MODELS}


def program_dims(engine) -> dict:
    """The program's PyanNet and ECAPA widths, as the configuration lists
    them."""
    from clearconverse_tpu_torch.models.ecapa import EcapaDims
    from clearconverse_tpu_torch.models.pyannet import PyannetDims

    def plain(dims):
        return {k: list(v) if isinstance(v, tuple) else v
                for k, v in dataclasses.asdict(dims).items()}

    bundle = engine.models
    return {"pyannet": plain(bundle._pyannet_dims or PyannetDims()),
            "ecapa": plain(bundle._ecapa_dims or EcapaDims())}


def draw(dims: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    return speaker_weights(dims, seed, device)


def fill(engine, weights: Dict[str, Dict[str, torch.Tensor]]) -> None:
    bundle = engine.models
    fill_tree(bundle._pyannet, weights["pyannet"])
    fill_tree(bundle._ecapa, weights["ecapa"])


class SpeakerRecorder:
    """Wraps ``models.pyannet.pyannet_forward`` and
    ``models.ecapa.ecapa_embed``, which the program's bundle looks up at
    each call. While ``active``, keeps a sample of each model's calls
    whole: the audio rows (and valid samples) it took and what it
    returned. ``fault`` (a dict of model name to a function of the
    output) breaks the output where it is produced."""

    def __init__(self, rng: np.random.Generator, sample: int = 2):
        from clearconverse_tpu_torch.models import ecapa, pyannet
        self.active = False
        self.fault: dict = {}
        self.keep = {"pyannet": Keeper(rng, sample),
                     "ecapa": Keeper(rng, sample)}

        def make(model, arg_names):
            def wrap(orig):
                sig = inspect.signature(orig)

                def wrapped(*args, **kwargs):
                    out = orig(*args, **kwargs)
                    if model in self.fault:
                        out = self.fault[model](out)
                    if self.active:
                        a = sig.bind(*args, **kwargs).arguments
                        rec = {k: a.get(k) for k in arg_names}
                        rec["out"] = out
                        self.keep[model].offer(rec, out.shape[0])
                    return out
                return wrapped
            return wrap

        self._patches = [
            Patch(pyannet, "pyannet_forward", make("pyannet", ("audio",))),
            Patch(ecapa, "ecapa_embed", make("ecapa", ("audio", "lengths")))]

    def kept(self, model: str) -> List[dict]:
        return self.keep[model].kept()

    def remove(self) -> None:
        for p in self._patches:
            p.remove()


def recorder(rng: np.random.Generator, sample: int) -> SpeakerRecorder:
    return SpeakerRecorder(rng, sample)


def _embed_gap(got: torch.Tensor, ref: torch.Tensor, rows) -> float:
    d = (got[rows].double() - ref[rows].double()).norm(dim=1)
    return float((d / ref[rows].double().norm(dim=1).clamp_min(1e-30)).max())


def speaker_readings(seg: List[dict], emb: List[dict], dims: dict,
                     weights: Dict[str, Dict[str, torch.Tensor]],
                     control: bool = False, row_block: int = 512) -> dict:
    """{"numbers": {"seg_logprob_gap", "embed_gap"}, "control": the same
    for the TF32 reference (with ``control``), "seg_rows", "embed_rows"}."""
    out = {"numbers": {}, "control": {}, "seg_rows": 0, "embed_rows": 0}
    sides = (False, True) if control else (False,)
    if seg:
        worst = {s: 0.0 for s in sides}
        for rec in seg:
            got = rec["out"].float()
            for r0 in range(0, got.shape[0], row_block):
                a = rec["audio"][r0: r0 + row_block]
                ref = pyannet_logprobs(weights["pyannet"], dims["pyannet"], a)
                g = got[r0: r0 + row_block].to(ref.device)
                worst[False] = max(worst[False], float((g - ref).abs().max()))
                if control:
                    low = pyannet_logprobs(weights["pyannet"], dims["pyannet"],
                                           a, tf32=True)
                    worst[True] = max(worst[True], float((low - ref).abs().max()))
            out["seg_rows"] += got.shape[0]
        out["numbers"]["seg_logprob_gap"] = worst[False]
        if control:
            out["control"]["seg_logprob_gap"] = worst[True]
    if emb:
        worst = {s: 0.0 for s in sides}
        for rec in emb:
            audio, got = rec["audio"], rec["out"].float()
            B, T = audio.shape
            lens = rec["lengths"]
            lens = (torch.full((B,), T, device=audio.device) if lens is None
                    else lens.to(audio.device))
            valid = (lens.long() * (1 + T // 160) + T // 2) // T
            for r0 in range(0, B, row_block):
                sl = slice(r0, min(B, r0 + row_block))
                rows = torch.nonzero(valid[sl] > 0).flatten()
                if not len(rows):
                    continue
                ref = ecapa_embeddings(weights["ecapa"], dims["ecapa"],
                                       audio[sl], lens[sl])
                worst[False] = max(worst[False], _embed_gap(
                    got[sl].to(ref.device), ref, rows))
                if control:
                    low = ecapa_embeddings(weights["ecapa"], dims["ecapa"],
                                           audio[sl], lens[sl], tf32=True)
                    worst[True] = max(worst[True], _embed_gap(low, ref, rows))
                out["embed_rows"] += len(rows)
        out["numbers"]["embed_gap"] = worst[False]
        if control:
            out["control"]["embed_gap"] = worst[True]
    return out


def readings(recorder: SpeakerRecorder, dims: dict, seed: int, device,
             control: bool) -> dict:
    """The kept calls against the references, on the seed's weights drawn
    anew."""
    s = speaker_readings(recorder.kept("pyannet"), recorder.kept("ecapa"),
                         dims, speaker_weights(dims, seed, device), control)
    return {"numbers": s["numbers"], "control": s["control"],
            "counts": {"seg_rows": s["seg_rows"],
                       "embed_rows": s["embed_rows"]}}


def altered_scores(out: torch.Tensor) -> torch.Tensor:
    """The powerset scores of the first frame of the first row reversed."""
    out = out.clone()
    out[0, 0] = out[0, 0].flip(-1)
    return out


def altered_embedding(out: torch.Tensor) -> torch.Tensor:
    """The first row's embedding reversed."""
    out = out.clone()
    out[0] = out[0].flip(-1)
    return out


FAULTS = {"altered_scores": ("pyannet", altered_scores),
          "altered_embedding": ("ecapa", altered_embedding)}
