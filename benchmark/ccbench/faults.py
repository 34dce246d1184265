"""Faults planted under the timed path, to show that the check sees them:
each breaks one model's answer where it is produced. ``FAULTS`` maps a
name to (the model whose calls it breaks, the function of the output)."""

from __future__ import annotations

import torch


def altered_token(out: dict) -> dict:
    """The second served token of every row replaced where the decode
    produced it (a text token, never EOT)."""
    packed = out["packed"].clone()
    tok = packed[:, 1]
    packed[:, 1] = torch.where(tok == 1000, 1001, 1000).to(packed.dtype)
    return {**out, "packed": packed}


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


FAULTS = {"altered_token": ("decode", altered_token),
          "altered_scores": ("pyannet", altered_scores),
          "altered_embedding": ("ecapa", altered_embedding)}
