"""RE-SepFormer position-wise feed-forward sublayer (csrc/sb_ffn.cu).

A port-only kernel: the JAX package has no Pallas kernel for the separator.
``sb_ffn`` computes ``h + fc2(ReLU(fc1(LayerNorm(h))))`` over rows of
``D_MODEL``, the residual included, with the 1024-wide hidden kept on the
SM. For a CUDA tensor it launches the kernel; for a CPU tensor it runs
``sb_ffn_plain``; it never falls back from one to the other.
``sb_ffn.launches`` counts the kernel launches.

The kernel runs both products as 3xTF32 ``wgmma`` on the tensor cores, as
K1 does (ops/logmel.py). ``ffn_operands`` lays out its weight stages with
K1's host helpers: fc1's and fc2's weights split into exact TF32 hi/lo
halves (``split_tf32``), cut into the 32 KB stages its TMA ring copies, in
the 32-byte swizzle its ``wgmma`` descriptors name (``sw32``), fc2's columns permuted
within each group of 8 (``W2_PERM``) to match the k-slots of the register A
operand the kernel builds from its hidden accumulator. ``prepare`` splits a
layer's weights once; ``operands`` splits them again when either weight has
changed in place (its version counter moved: ``copy_``, ``load_state_dict``;
a write through ``.data`` moves none) or was replaced.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from clearconverse_tpu_torch.ops import build
from clearconverse_tpu_torch.ops.logmel import split_tf32, sw32

D_MODEL = 128          # the kernel's row width (the published separator's)
CHUNK = 64             # hidden units a chunk; d_ffn must be a multiple
STAGE_FLOATS = 8192    # 32 KB a ring stage
STAGES_PER_CHUNK = 4   # fc1's two halves of K, fc2's two halves of the chunk
# fc2's columns within each group of 8 hidden units, in the k-slot order of
# a TF32 A fragment: slot s holds unit 2s, slot s + 4 unit 2s + 1.
W2_PERM = (0, 2, 4, 6, 1, 3, 5, 7)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("sb_ffn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cc_sb_ffn.argtypes = [p, i, p, p, ctypes.c_float, p,
                              ctypes.c_longlong, i, p, p, p, p]
    lib.cc_sb_ffn.restype = i
    return lib


def fused(d_model: int, d_ffn: int) -> bool:
    """Whether the kernel takes a layer of these widths."""
    return d_model == D_MODEL and d_ffn >= CHUNK and d_ffn % CHUNK == 0


def ffn_operands(w1: torch.Tensor, w2: torch.Tensor) -> np.ndarray:
    """The kernel's weight stages, f32, for fc1 [d_ffn, 128] and fc2 [128,
    d_ffn], laid out on the host. Per chunk of CHUNK hidden units, four
    stages of STAGE_FLOATS: fc1's k8-steps 0-7, then 8-15 (each a hi then a
    lo [64 units, 8 inputs] tile), then fc2's k8-steps 0-3, then 4-7 of the
    chunk (each a hi then a lo [128 outputs, 8 units in W2_PERM order]
    tile), every tile swizzled (K1's ``sw32``: every tile has a multiple of
    8 rows, so one pass over all of them swizzles each)."""
    a1, a2 = (w.detach().float().cpu().numpy() for w in (w1, w2))
    f, d = a1.shape
    nc = f // CHUNK
    t1 = np.stack(split_tf32(a1)).reshape(2, nc, CHUNK, d // 8, 8)
    t1 = t1.transpose(1, 3, 0, 2, 4).reshape(nc, 2, STAGE_FLOATS)
    t2 = np.stack(split_tf32(a2)).reshape(2, d, nc, CHUNK // 8, 8)
    t2 = t2[..., list(W2_PERM)].transpose(2, 3, 0, 1, 4)
    stages = np.concatenate([t1, t2.reshape(nc, 2, STAGE_FLOATS)], axis=1)
    return sw32(stages.reshape(-1, 8))


# fc1's weight → (its key when split, the stages).
_SPLITS = WeakIdKeyDictionary()


def _key(w1: torch.Tensor, w2: torch.Tensor) -> tuple:
    return (w1.data_ptr(), w1._version, w2.data_ptr(), w2._version)


def operands(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """``ffn_operands(w1, w2)``, kept beside fc1's weight and made again
    when either weight changed since."""
    kept = _SPLITS.get(w1)
    if kept is not None and kept[0] == _key(w1, w2):
        return kept[1]
    ops = torch.from_numpy(ffn_operands(w1, w2)).to(w1.device)
    _SPLITS[w1] = (_key(w1, w2), ops)
    return ops


def prepare(w1: torch.Tensor, w2: torch.Tensor) -> None:
    """Splits a layer's weights for the kernel ahead of its first call,
    where the kernel takes them (CUDA, float32, fused widths)."""
    if (w1.device.type == "cuda" and w1.dtype == torch.float32
            and fused(w1.shape[1], w1.shape[0])):
        operands(w1, w2)


def sb_ffn_plain(h: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's plain version: h + fc2(ReLU(fc1(LN(h))))."""
    x = F.layer_norm(h, (h.shape[-1],), ln_w, ln_b, eps)
    return h + F.linear(F.relu(F.linear(x, w1, b1)), w2, b2)


def check(h: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
          w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
          b2: torch.Tensor) -> None:
    """Raises ValueError unless the kernel takes these: float32 on one
    device, h [..., D_MODEL] contiguous and 16-byte aligned, fc1 [d_ffn,
    D_MODEL] and fc2 [D_MODEL, d_ffn] with d_ffn a multiple of CHUNK,
    contiguous weights."""
    params = (ln_w, ln_b, w1, b1, w2, b2)
    if h.dtype != torch.float32 or any(p.dtype != torch.float32
                                       for p in params):
        raise ValueError(f"sb_ffn: want float32, got {h.dtype} and "
                         f"{[p.dtype for p in params]}")
    if any(p.device != h.device for p in params):
        raise ValueError("sb_ffn: weights must be on the input's device")
    f = w1.shape[0]
    if (h.ndim < 1 or not fused(h.shape[-1], f)
            or tuple(w1.shape) != (f, D_MODEL)
            or tuple(w2.shape) != (D_MODEL, f)
            or tuple(b1.shape) != (f,)
            or any(tuple(p.shape) != (D_MODEL,) for p in (ln_w, ln_b, b2))):
        raise ValueError(f"sb_ffn: want rows of {D_MODEL} and d_ffn a "
                         f"multiple of {CHUNK}, got h {tuple(h.shape)}, "
                         f"fc1 {tuple(w1.shape)}, fc2 {tuple(w2.shape)}")
    if not h.is_contiguous() or h.data_ptr() % 16:
        raise ValueError("sb_ffn: h must be contiguous and 16-byte aligned")
    if any(not p.is_contiguous() for p in params):
        raise ValueError("sb_ffn: weights must be contiguous")


def sb_ffn(h: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
           w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
           b2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """h [..., 128] float32 → h + fc2(ReLU(fc1(LN(h)))), fc1 [d_ffn, 128],
    fc2 [128, d_ffn]. CPU tensor: the plain version. CUDA tensor: the
    kernel, which takes what ``check`` passes and raises otherwise."""
    if h.device.type == "cpu":
        return sb_ffn_plain(h, ln_w, ln_b, w1, b1, w2, b2, eps)
    if h.device.type != "cuda":
        raise ValueError(f"sb_ffn: unsupported device {h.device}")
    check(h, ln_w, ln_b, w1, b1, w2, b2)
    f = w1.shape[0]
    rows = h.numel() // D_MODEL
    out = torch.empty_like(h)
    if rows == 0:
        return out
    ops = operands(w1, w2)
    rc = _lib().cc_sb_ffn(
        h.data_ptr(), rows, ln_w.data_ptr(), ln_b.data_ptr(), eps,
        ops.data_ptr(), ops.numel() * 4, f, b1.data_ptr(), b2.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cc_sb_ffn launch failed: CUDA error {rc}")
    sb_ffn.launches += 1
    return out


sb_ffn.launches = 0
