"""Kernel K2: Whisper encoder self-attention (csrc/encoder_attention.cu).

Port of the forward pass of the JAX package's Pallas TPU kernel
``encoder_attention_pallas`` (clearconverse_tpu/ops/pallas/
encoder_attention.py), and the counterpart of the library flash kernel
behind ``clearconverse_tpu.models.whisper._flash_attention`` (same
function). bf16 runs a wgmma + TMA flash kernel, f32 a scalar one.
``encoder_attention`` launches the CUDA kernel for CUDA tensors and runs
``encoder_attention_plain`` for CPU tensors; it never falls back from one to
the other. ``encoder_attention.launches`` counts the kernel launches.

Differentiable, as the JAX kernel's custom VJP is: when grad mode is on and
an input requires grad, the call goes through ``_EncoderAttention``, whose
forward is the same kernel (or plain version) and whose backward recomputes
through the plain einsum attention (``models/whisper.attention``). There is
no backward kernel, as there is none in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from clearconverse_tpu_torch.ops import build
from clearconverse_tpu_torch.utils.precision import full_f32

HEAD_DIM = 64   # the kernel's only head width (every Whisper size)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("encoder_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.cc_encoder_attention_f32, lib.cc_encoder_attention_bf16):
        fn.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return lib


def encoder_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, n_head: int) -> torch.Tensor:
    """K2's plain version, with the Pallas forward's semantics: q scaled by
    dh^-0.5 in q's dtype, f32 logits and softmax, p cast to v's dtype, p·V
    accumulated in f32, the output cast to q's dtype. [B, T, D] → [B, T, D]."""
    B, T, D = q.shape
    dh = D // n_head

    def heads(x):
        return x.reshape(B, -1, n_head, dh).transpose(1, 2).float()

    with full_f32():
        s = torch.matmul(heads(q * dh ** -0.5), heads(k).transpose(-1, -2))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.matmul(p.float(), heads(v))
    return o.transpose(1, 2).reshape(B, T, D).to(q.dtype)


class _EncoderAttention(torch.autograd.Function):
    """K2 with the JAX custom VJP's backward: the forward launches the
    kernel (plain version on the CPU) and saves q, k, v; the backward
    differentiates the plain einsum attention at those inputs."""

    @staticmethod
    def forward(ctx, q, k, v, n_head):
        ctx.save_for_backward(q, k, v)
        ctx.n_head = n_head
        return _forward(q, k, v, n_head)

    @staticmethod
    def backward(ctx, g):
        from clearconverse_tpu_torch.models.whisper import attention
        q, k, v = (x.detach().requires_grad_(True) for x in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention(q, k, v, None, ctx.n_head)
        return (*torch.autograd.grad(out, (q, k, v), g), None)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      n_head: int) -> torch.Tensor:
    """q, k, v: [B, T, D] → [B, T, D]; full (unmasked) attention over T.
    CPU tensors: the plain version. CUDA tensors: the kernel, which takes
    contiguous, 16-byte aligned bf16 or f32 inputs with 64-wide heads and
    raises otherwise. With grad mode on and an input that requires grad,
    the result carries ``_EncoderAttention``'s backward."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _EncoderAttention.apply(q, k, v, n_head)
    return _forward(q, k, v, n_head)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             n_head: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, n_head)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention: unsupported device {q.device}")
    if q.ndim != 3 or any(x.shape != q.shape for x in (k, v)):
        raise ValueError("encoder_attention: q, k, v must share one [B, T, D]")
    if any(x.device != q.device or x.dtype != q.dtype for x in (k, v)):
        raise ValueError("encoder_attention: q, k, v must share device and dtype")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"encoder_attention: unsupported dtype {q.dtype}")
    B, T, D = q.shape
    if D != n_head * HEAD_DIM:
        raise ValueError(f"encoder_attention: D={D} is not {n_head} heads "
                         f"of {HEAD_DIM}")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("encoder_attention: inputs must be contiguous")
    # TMA (bf16) takes only 16-byte aligned bases and row strides.
    if any(x.data_ptr() % 16 or x.stride(1) * x.element_size() % 16
           for x in (q, k, v)):
        raise ValueError("encoder_attention: inputs must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _lib()
    fn = (lib.cc_encoder_attention_bf16 if q.dtype == torch.bfloat16
          else lib.cc_encoder_attention_f32)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T,
            n_head, HEAD_DIM ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"encoder attention launch failed: CUDA error {rc}")
    encoder_attention.launches += 1
    return out


encoder_attention.launches = 0
