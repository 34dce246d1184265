"""Which errors the engine's per-file isolation must never swallow."""

from __future__ import annotations

import torch

_DEVICE_ERRORS = tuple(t for t in (getattr(torch, "AcceleratorError", None),
                                   getattr(torch.cuda, "CudaError", None))
                       if t is not None)


def is_fatal(exc: BaseException) -> bool:
    """True for a missing piece of the port (``NotImplementedError``) and
    for a CUDA failure (a launch, an illegal access, device memory): caught
    and logged, either would turn into a quietly different transcript
    instead of a failed run."""
    if isinstance(exc, (NotImplementedError,) + _DEVICE_ERRORS):
        return True
    return isinstance(exc, RuntimeError) and "CUDA" in str(exc)
