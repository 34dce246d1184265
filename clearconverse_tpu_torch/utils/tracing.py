"""Per-stage wall-clock spans and device traces.

``StageTimer`` is the JAX package's span recorder; ``force_sync`` is the
barrier a timed span ends with on a CUDA card; ``device_trace`` is the JAX
package's trace context manager over ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)


def force_sync() -> None:
    """Wait for every queued CUDA kernel; a no-op without a card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulates labeled spans; nested use via the context manager.

    ``totals_only=True`` keeps running per-key totals instead of the
    append-only span list — for long-lived timers (ModelBundle records a
    span per device call for the life of the process). ``sync=True`` starts
    and ends every span with ``force_sync``, so a span times the device
    work queued inside it rather than its launches."""

    def __init__(self, totals_only: bool = False, sync: bool = False):
        self.spans: List[Tuple[str, float]] = []
        self._totals: Optional[Dict[str, float]] = {} if totals_only else None
        self._sync = sync
        # Event counts beside the spans (e.g. the token loop's steps, so a
        # reader can turn its span into a time per step).
        self.counts: Dict[str, int] = {}

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    @contextlib.contextmanager
    def stage(self, name: str):
        if self._sync:
            force_sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                force_sync()
            dt = time.perf_counter() - t0
            if self._totals is not None:
                self._totals[name] = self._totals.get(name, 0.0) + dt
            else:
                self.spans.append((name, dt))

    def as_dict(self) -> Dict[str, float]:
        if self._totals is not None:
            return dict(self._totals)
        out: Dict[str, float] = {}
        for name, dt in self.spans:
            out[name] = out.get(name, 0.0) + dt
        return out

    def summary(self) -> str:
        items = (self.spans if self._totals is None
                 else list(self._totals.items()))
        total = sum(dt for _, dt in items)
        parts = [f"{name}={dt:.2f}s" for name, dt in items]
        return f"total={total:.2f}s " + " ".join(parts)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over the block (the CPU, and the card when there
    is one), written to ``log_dir`` as a Chrome trace
    (``trace_<pid>_<ms>.json``, which Perfetto and chrome://tracing open);
    yields the profiler. A no-op that yields None when ``log_dir`` is
    None or empty. A trace of a whole decode call on the card is large
    (tens of MB)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_"
                                 f"{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)
