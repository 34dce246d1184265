"""RE-SepFormer segment attention (csrc/sb_attention.cu).

A port-only kernel: the JAX package has no Pallas kernel for the separator.
``seg_attention`` takes the in-projection's output of a segment block,
``[B, T, 3D]`` (each row of B one segment of T frames), and returns
softmax(q kᵀ dh^-0.5) v per head as ``[B, T, D]``, ready for the
out-projection. For a CUDA tensor it launches the kernel; for a CPU tensor
it runs ``seg_attention_plain``; it never falls back from one to the other.
``seg_attention.launches`` counts the kernel launches.

The kernel takes unmasked attention over at most ``MAX_KEYS`` keys with
heads of ``HEAD_DIM``: every layer of a segment block. ``fused`` says
whether a call takes it; the memory block's attention over a row's
segments is masked and stays on the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from clearconverse_tpu_torch.ops import build

HEAD_DIM = 16    # the published separator's heads: 128 wide, 8 heads
MAX_KEYS = 256   # the longest segment a CTA takes (the published K is 150)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("sb_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cc_sb_seg_attention.argtypes = [p, p, i, i, i, ctypes.c_float, p]
    lib.cc_sb_seg_attention.restype = i
    return lib


def fused(qkv_shape, n_heads: int, key_ok: Optional[torch.Tensor]) -> bool:
    """Whether the kernel takes a call: no key mask, at most MAX_KEYS keys,
    heads of HEAD_DIM."""
    return (key_ok is None and qkv_shape[-2] <= MAX_KEYS
            and qkv_shape[-1] == 3 * n_heads * HEAD_DIM)


def seg_attention_plain(qkv: torch.Tensor, n_heads: int,
                        key_ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's plain version, and the memory block's attention:
    qkv [B, T, 3D] → [B, T, D]; ``key_ok`` [B, T] masks keys."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    dh = D // n_heads
    q, k, v = qkv.chunk(3, -1)
    q = q.reshape(B, T, n_heads, dh).transpose(1, 2) * dh ** -0.5
    k = k.reshape(B, T, n_heads, dh).transpose(1, 2)
    v = v.reshape(B, T, n_heads, dh).transpose(1, 2)
    s = torch.matmul(q, k.transpose(-1, -2))
    if key_ok is not None:
        s = s.masked_fill(~key_ok[:, None, None, :], float("-inf"))
    o = torch.matmul(torch.softmax(s, dim=-1), v)
    return o.transpose(1, 2).reshape(B, T, D)


def check(qkv: torch.Tensor, n_heads: int) -> None:
    """Raises ValueError unless the kernel takes ``qkv``: [B, T, 3D]
    float32, contiguous and 16-byte aligned, T <= MAX_KEYS, heads of
    HEAD_DIM."""
    if qkv.dtype != torch.float32 or qkv.ndim != 3:
        raise ValueError(f"seg_attention: want [B, T, 3D] float32, got "
                         f"{tuple(qkv.shape)} {qkv.dtype}")
    B, T, D3 = qkv.shape
    if not fused(qkv.shape, n_heads, None):
        raise ValueError(f"seg_attention: T={T} above {MAX_KEYS} or width "
                         f"{D3} not 3 x {n_heads} heads of {HEAD_DIM}")
    if B < 1 or T < 1:
        raise ValueError(f"seg_attention: empty input {tuple(qkv.shape)}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("seg_attention: qkv must be contiguous and 16-byte "
                         "aligned")


def seg_attention(qkv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """qkv [B, T, 3D] float32 → [B, T, D], unmasked over each row's T
    keys. CPU tensor: the plain version. CUDA tensor: the kernel, which
    takes contiguous, 16-byte aligned rows, T <= MAX_KEYS and heads of
    HEAD_DIM, and raises otherwise."""
    if qkv.device.type == "cpu":
        return seg_attention_plain(qkv, n_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"seg_attention: unsupported device {qkv.device}")
    check(qkv, n_heads)
    B, T, D3 = qkv.shape
    out = torch.empty((B, T, D3 // 3), dtype=torch.float32, device=qkv.device)
    rc = _lib().cc_sb_seg_attention(
        qkv.data_ptr(), out.data_ptr(), B, T, n_heads, HEAD_DIM ** -0.5,
        torch.cuda.current_stream(qkv.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cc_sb_seg_attention launch failed: CUDA error {rc}")
    seg_attention.launches += 1
    return out


seg_attention.launches = 0
