"""The port's ``Whisper`` in openai-whisper's checkpoint format.

``whisper_to_openai_state_dict`` is the exact inverse of the loader's
``models/convert._convert_openai``: conv weights stay torch's [Cout, Cin, k],
linear weights [out, in], and the attention ``key`` projections carry no
bias (openai's have none). ``export_whisper_pt`` writes the ``{size}.pt``
layout (``dims`` + ``model_state_dict``) that ``models/convert.load_whisper``
and openai-whisper read.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np
import torch

from clearconverse_tpu_torch.models.whisper import Whisper, WhisperDims


def whisper_to_openai_state_dict(model: Whisper) -> Dict[str, np.ndarray]:
    """openai-whisper state-dict names → f32 numpy arrays."""
    sd: Dict[str, np.ndarray] = {}

    def put(key: str, t: torch.Tensor) -> None:
        sd[key] = np.ascontiguousarray(t.detach().float().cpu().numpy())

    def lin(prefix: str, mod) -> None:
        put(f"{prefix}.weight", mod.weight)
        if mod.bias is not None:
            put(f"{prefix}.bias", mod.bias)

    def block(pre: str, blk) -> None:
        put(f"{pre}.attn_ln.weight", blk.attn_ln.weight)
        put(f"{pre}.attn_ln.bias", blk.attn_ln.bias)
        for name, attr in (("query", "q"), ("key", "k"), ("value", "v"),
                           ("out", "out")):
            lin(f"{pre}.attn.{name}", getattr(blk.attn, attr))
        if hasattr(blk, "cross"):
            put(f"{pre}.cross_attn_ln.weight", blk.cross_ln.weight)
            put(f"{pre}.cross_attn_ln.bias", blk.cross_ln.bias)
            for name, attr in (("query", "q"), ("key", "k"), ("value", "v"),
                               ("out", "out")):
                lin(f"{pre}.cross_attn.{name}", getattr(blk.cross, attr))
        put(f"{pre}.mlp_ln.weight", blk.mlp_ln.weight)
        put(f"{pre}.mlp_ln.bias", blk.mlp_ln.bias)
        lin(f"{pre}.mlp.0", blk.mlp.fc1)
        lin(f"{pre}.mlp.2", blk.mlp.fc2)

    enc, dec = model.encoder, model.decoder
    for conv in ("conv1", "conv2"):
        lin(f"encoder.{conv}", getattr(enc, conv))
    put("encoder.positional_embedding", enc.pos)
    for i, blk in enumerate(enc.blocks):
        block(f"encoder.blocks.{i}", blk)
    put("encoder.ln_post.weight", enc.ln_post.weight)
    put("encoder.ln_post.bias", enc.ln_post.bias)
    put("decoder.token_embedding.weight", dec.tok)
    put("decoder.positional_embedding", dec.pos)
    for i, blk in enumerate(dec.blocks):
        block(f"decoder.blocks.{i}", blk)
    put("decoder.ln.weight", dec.ln.weight)
    put("decoder.ln.bias", dec.ln.bias)
    return sd


def export_whisper_pt(model: Whisper, dims: WhisperDims, path: str,
                      half: bool = False) -> str:
    """Write an openai-whisper ``.pt`` (``dims`` + ``model_state_dict``);
    ``half`` stores fp16 tensors, as openai's own checkpoints are."""
    dtype = torch.float16 if half else torch.float32
    sd = {k: torch.from_numpy(v).to(dtype)
          for k, v in whisper_to_openai_state_dict(model).items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"dims": dataclasses.asdict(dims), "model_state_dict": sd},
               path)
    return path
