"""Float32 and bf16 precision pinning."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Run f32 matmuls and cuDNN convolutions in IEEE f32 inside the block.

    On a CUDA card cuDNN convolutions default to TF32 (about three decimal
    digits); the JAX reference runs these products at HIGHEST precision. The
    caller's settings are restored on exit."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def pin_bf16_reductions() -> None:
    """Make cuBLAS sum bf16 products in f32 in every GEMM of the process.

    PyTorch lets cuBLAS reduce a bf16 GEMM's partial sums in bf16 by
    default (``allow_bf16_reduced_precision_reduction``); the JAX package
    accumulates every product in f32 (``preferred_element_type``). The
    bundle and the bench turn it off for the process."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
