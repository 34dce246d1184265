"""Int8 weights for the decoder's linears.

The port of the JAX package's ops/quantize.py. Every decode step reads
every decoder weight; symmetric per-output-channel int8 codes halve what is
stored for them against bf16. Only the decoder blocks' linears are
quantized: the encoder (run once per segment), ``tok`` (whose logits drive
the argmax) and the layer norms stay in full precision.

The port stores a linear's weight as ``[out, in]``, so a channel's ``amax``
runs over dim 1 (the JAX package's ``[in, out]`` takes it over axis 0);
``torch.round`` rounds half to even as ``jnp.round`` does, so the codes and
scales equal the JAX package's. ``dense_quantized`` is plain PyTorch, as
the JAX package computes it with ``jnp.dot`` outside any kernel: the codes
widen to the activations' dtype and the product runs in it, the scale and
the bias apply in f32.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``[out, in]`` float → {"wq": int8 [out, in], "scale": f32 [out]}
    (symmetric, per output channel)."""
    w = w.detach().float()
    scale = torch.clamp(w.abs().amax(dim=1) / 127.0, min=1e-12)
    wq = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return {"wq": wq.to(torch.int8), "scale": scale}


class QuantizedLinear(nn.Module):
    """An ``nn.Linear`` as int8 codes ``wq`` [out, in], f32 per-channel
    ``scale`` [out] and the linear's own ``bias`` (or None), as buffers."""

    def __init__(self, wq: torch.Tensor, scale: torch.Tensor, bias=None):
        super().__init__()
        self.register_buffer("wq", wq)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "QuantizedLinear":
        q = quantize_weight(lin.weight)
        bias = None if lin.bias is None else lin.bias.detach().clone()
        return cls(q["wq"], q["scale"], bias)

    @property
    def out_features(self) -> int:
        return self.wq.shape[0]


def dense_quantized(x: torch.Tensor, lin: QuantizedLinear,
                    bias: bool = True) -> torch.Tensor:
    """``x`` against an int8 linear: (x @ wq^T) · scale + b, returned in
    ``x``'s dtype; ``bias=False`` leaves ``b`` out."""
    y = F.linear(x, lin.wq.to(x.dtype)).float() * lin.scale.float()
    if bias and lin.bias is not None:
        y = y + lin.bias.float()
    return y.to(x.dtype)


@torch.no_grad()
def quantize_whisper_decoder(model: nn.Module) -> nn.Module:
    """A new Whisper whose decoder blocks' q, k, v, out (self and cross)
    and fc1, fc2 are ``QuantizedLinear``s; every other parameter is shared
    with ``model``, which is left as it was."""
    memo = {id(t): t for t in list(model.parameters()) + list(model.buffers())}
    out = copy.deepcopy(model, memo)
    for blk in out.decoder.blocks:
        for group in (blk.attn, blk.cross):
            for name in ("q", "k", "v", "out"):
                setattr(group, name,
                        QuantizedLinear.from_linear(getattr(group, name)))
        blk.mlp.fc1 = QuantizedLinear.from_linear(blk.mlp.fc1)
        blk.mlp.fc2 = QuantizedLinear.from_linear(blk.mlp.fc2)
    return out
