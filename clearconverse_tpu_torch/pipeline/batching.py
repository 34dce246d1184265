"""Batch planner: duration-bucketed, fixed-shape batches (numpy only).

Segments are grouped into duration buckets so each batch has one of a few
fixed shapes and padding waste stays bounded.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np


def pick_bucket(duration_s: float, buckets: Sequence[float]) -> float:
    for b in sorted(buckets):
        if duration_s <= b:
            return b
    return sorted(buckets)[-1]


def batch_audio(
    clips: Sequence[np.ndarray],
    sr: int,
    buckets: Sequence[float] = (5.0, 10.0, 30.0),
    batch_size: int = 8,
) -> Iterator[Tuple[List[int], np.ndarray, np.ndarray]]:
    """Yield (original_indices, padded [B, T_bucket], lengths [B]) batches.

    Items are grouped by bucket; each batch is padded to its bucket's length.
    Clips longer than the largest bucket are trimmed to it."""
    order: List[Tuple[float, int]] = []
    for i, clip in enumerate(clips):
        dur = len(clip) / sr
        order.append((pick_bucket(dur, buckets), i))
    order.sort(key=lambda x: (x[0], x[1]))

    group: List[int] = []
    cur_bucket = None
    for bucket, idx in order + [(None, -1)]:
        if bucket != cur_bucket or len(group) == batch_size:
            if group:
                T = int(cur_bucket * sr)
                out = np.zeros((len(group), T), np.float32)
                lens = np.zeros(len(group), np.int64)
                for row, j in enumerate(group):
                    c = np.asarray(clips[j], np.float32).reshape(-1)[:T]
                    out[row, : len(c)] = c
                    lens[row] = max(len(c), 1)
                yield group, out, lens
            group = []
            cur_bucket = bucket
        if idx >= 0:
            group.append(idx)


def split_long(clip, sr: int, max_s: float = 30.0) -> List:
    """Split a clip into ≤max_s pieces (whisper's window). A clip within the
    limit comes back as is, so a lazy clip stays unread."""
    limit = int(max_s * sr)
    if len(clip) <= limit:
        return [clip]
    return [clip[i : i + limit] for i in range(0, max(len(clip), 1), limit)]
