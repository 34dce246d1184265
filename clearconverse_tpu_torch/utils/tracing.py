"""Per-stage wall-clock spans, on the profiler's clock while it runs.

``StageTimer`` is the JAX package's span recorder; ``force_sync`` is the
barrier a timed span ends with on a CUDA card.

While ``torch.profiler`` runs, every span also opens a profiler range
named ``cc:<scope>.<name>`` (``cc:<name>`` without a scope), so the spans
sit on the device trace's clock. With the profiler off a span costs one
read of its enabled flag more than its ``perf_counter`` pair.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch
# A range whose keyword values land in the trace's args (with
# record_shapes), unlike record_function's string.
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

# Every range name starts with it; a trace reader finds the port's spans
# by it.
RANGE_PREFIX = "cc:"


def force_sync() -> None:
    """Wait for every queued CUDA kernel; a no-op without a card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _open_range(key: str, args: Optional[Dict[str, int]]):
    """An entered profiler range ``cc:<key>``, or None while the current
    stream captures a CUDA graph: a captured chunk holds no range."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return None
    rng = _RecordFunctionFast(RANGE_PREFIX + key, [], args or {})
    rng.__enter__()
    return rng


class StageTimer:
    """Accumulates labeled spans; nested use via the context manager.

    ``totals_only=True`` keeps running per-key totals instead of the
    append-only span list — for long-lived timers (ModelBundle records a
    span per device call for the life of the process). ``sync=True`` starts
    and ends every span with ``force_sync``, so a span times the device
    work queued inside it rather than its launches.

    ``scope`` prefixes the profiler range names of this timer's spans
    (``cc:<scope>.<name>``), so a name is unique by level; ``args`` (e.g.
    ``{"file": 3}``) go with every range, so one file's spans share an
    identifier. Neither changes the recorded keys."""

    def __init__(self, totals_only: bool = False, sync: bool = False,
                 scope: Optional[str] = None,
                 args: Optional[Dict[str, int]] = None):
        self.spans: List[Tuple[str, float]] = []
        self._totals: Optional[Dict[str, float]] = {} if totals_only else None
        self._sync = sync
        self._scope = scope
        self._args = args
        # Event counts beside the spans (e.g. the token loop's steps, so a
        # reader can turn its span into a time per step).
        self.counts: Dict[str, int] = {}

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    @contextlib.contextmanager
    def stage(self, name: str, scope: Optional[str] = None):
        """Span ``name``; ``scope`` overrides the timer's for its range."""
        rng = None
        if _profiler._is_profiler_enabled:
            scope = scope or self._scope
            rng = _open_range(f"{scope}.{name}" if scope else name,
                              self._args)
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
            if rng is not None:
                rng.__exit__(None, None, None)

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
