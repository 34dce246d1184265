"""Reduces a ``torch.profiler`` trace of the card, in memory: busy time
(the union of the intervals in which a kernel, copy or set ran), time by
kernel name, and the idle gaps named by the host operation that was
running at each gap's middle."""

from __future__ import annotations

import heapq
import time
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _on_device(ev) -> bool:
    """A kernel, copy or set that ran on the card. Builds whose events
    carry no activity type count every event on the card."""
    if ev.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    kind = getattr(ev, "activity_type", None)
    return kind is None or str(kind()).lower() in DEVICE_KINDS


class Trace:
    def __init__(self, window_s: float, device: List[Tuple[str, int, int]],
                 host: List[Tuple[str, int, int]]):
        self.window_s = window_s
        self.device = device          # (name, start ns, end ns)
        self.host = host
        self.by_name: Dict[str, float] = {}
        for name, a, b in device:
            self.by_name[name] = self.by_name.get(name, 0.0) + (b - a) * 1e-9
        merged: List[List[int]] = []
        for _, a, b in sorted(device, key=lambda e: e[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.merged = merged
        self.busy_s = sum(b - a for a, b in merged) * 1e-9

    def kernel_seconds(self, substring: str) -> float:
        return sum(s for n, s in self.by_name.items() if substring in n)

    def top_ops(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.by_name.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Seconds of idle device time summed by the innermost host
        operation running at each gap's middle ("host (no operation)" when
        none was)."""
        host = sorted(self.host, key=lambda e: e[1])
        totals: Dict[str, float] = {}
        active: list = []          # heap of (end, start, name)
        i = 0
        for (_, a), (b, _) in zip(self.merged, self.merged[1:]):
            mid = (a + b) // 2
            while i < len(host) and host[i][1] <= mid:
                heapq.heappush(active, (host[i][2], host[i][1], host[i][0]))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            best = min(active, key=lambda e: e[0] - e[1], default=None)
            label = best[2] if best else "host (no operation)"
            totals[label] = totals.get(label, 0.0) + (b - a) * 1e-9
        return [[k, v] for k, v in sorted(totals.items(),
                                          key=lambda kv: -kv[1])[:n]]


def traced(fn: Callable, device: torch.device):
    """Run ``fn()`` under the profiler; returns (its result, Trace)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if _on_device(ev):
            dev.append((ev.name(), start, end))
        elif ev.device_type() != torch.autograd.DeviceType.CUDA:
            host.append((ev.name(), start, end))
    return result, Trace(window, dev, host)
