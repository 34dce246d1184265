"""The comparison that decides ``correct``.

Whisper: for each decode call kept from the window, the reference
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

Speaker models: for each PyanNet and ECAPA call kept, the reference
recomputes the output from the audio rows the call took.
``seg_logprob_gap`` is the widest gap of a powerset log-probability
(nats); ``embed_gap`` the widest distance of a row's embedding from the
reference's, over the reference's norm. Rows with no valid frame (the
padding of a batch, one sample long) have no embedding to judge.

With ``control``, each number is read a second time with the reference
at the precision below the configuration's (fp8 operands for bf16
Whisper, TF32 for the float32 speaker models) in the program's place.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ccbench.reference import served_logprob_sums
from ccbench.speaker_reference import ecapa_embeddings, pyannet_logprobs


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
