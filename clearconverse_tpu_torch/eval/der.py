"""Diarization error rate with optimal speaker mapping.

DER = (missed speech + false alarm + speaker confusion) / total reference
speech time, computed over a timeline discretized at ``resolution`` seconds
with an optional no-score collar around reference boundaries (pyannote/NIST
convention). Reference↔hypothesis speaker mapping is EXACT for any speaker
count via the Hungarian algorithm (a greedy fallback above 8 speakers
would not be the optimal assignment).

A copy of the JAX package's eval/der.py for the port (host code).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

LabeledSegment = Tuple[float, float, str]


def hungarian_max(score: np.ndarray) -> Dict[int, int]:
    """Exact maximum-weight assignment on a [n_rows, n_cols] score matrix;
    returns {row: col} for the matched pairs (min(n, m) of them).

    Shortest-augmenting-path Hungarian with potentials (the classical
    O(n^2 m) formulation) on cost = -score. Speaker counts are tiny, so a
    plain-Python inner loop is more than fast enough."""
    n, m = score.shape
    if n == 0 or m == 0:
        return {}
    transposed = n > m
    if transposed:                      # the algorithm wants n <= m
        score = score.T
        n, m = m, n
    cost = -score.astype(np.float64)
    INF = float("inf")
    u = [0.0] * (n + 1)
    v = [0.0] * (m + 1)
    match = [0] * (m + 1)               # match[j] = row assigned to col j
    way = [0] * (m + 1)
    for i in range(1, n + 1):
        match[0] = i
        j0 = 0
        minv = [INF] * (m + 1)
        used = [False] * (m + 1)
        while True:
            used[j0] = True
            i0, delta, j1 = match[j0], INF, 0
            for j in range(1, m + 1):
                if used[j]:
                    continue
                cur = cost[i0 - 1][j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(m + 1):
                if used[j]:
                    u[match[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if match[j0] == 0:
                break
        while j0:                       # augment along the found path
            j1 = way[j0]
            match[j0] = match[j1]
            j0 = j1
    out = {match[j] - 1: j - 1 for j in range(1, m + 1) if match[j]}
    if transposed:
        out = {j: i for i, j in out.items()}
    return out


def _rasterize(segments: Sequence[LabeledSegment], speakers: List[str],
               n_frames: int, resolution: float) -> np.ndarray:
    grid = np.zeros((n_frames, len(speakers)), bool)
    index = {s: i for i, s in enumerate(speakers)}
    for start, end, spk in segments:
        # Clamp at 0: a slightly negative start (collar/padding arithmetic
        # upstream) must not wrap the numpy slice and erase the segment.
        lo = max(int(round(start / resolution)), 0)
        hi = min(int(round(end / resolution)), n_frames)
        grid[lo:hi, index[spk]] = True
    return grid


def diarization_error_rate(reference: Sequence[LabeledSegment],
                           hypothesis: Sequence[LabeledSegment],
                           collar: float = 0.25,
                           resolution: float = 0.01) -> Dict[str, float]:
    """Returns {"der", "missed", "false_alarm", "confusion", "total"} where
    the components are in seconds and "der" is their sum over total
    reference speech time."""
    ref_spks = sorted({s for _, _, s in reference})
    hyp_spks = sorted({s for _, _, s in hypothesis})
    end = max([e for _, e, _ in list(reference) + list(hypothesis)] + [0.0])
    n = int(round(end / resolution)) + 1
    R = _rasterize(reference, ref_spks, n, resolution)
    H = _rasterize(hypothesis, hyp_spks, n, resolution)

    # No-score collar around reference segment boundaries.
    score_mask = np.ones(n, bool)
    if collar > 0:
        c = int(round(collar / resolution))
        for start, e_, _ in reference:
            for t in (start, e_):
                f = int(round(t / resolution))
                score_mask[max(f - c, 0): f + c] = False
    R = R[score_mask]
    H = H[score_mask]

    # Optimal speaker mapping (maximize overlap time) — exact for any
    # speaker count (Hungarian).
    overlap = R.astype(np.int64).T @ H.astype(np.int64)   # [n_ref, n_hyp]
    best_map = hungarian_max(overlap)

    mapped = np.zeros_like(R)
    for i, j in best_map.items():
        mapped[:, i] = H[:, j]

    ref_count = R.sum(1)
    hyp_count = H.sum(1)
    total = float(ref_count.sum()) * resolution
    missed = float(np.maximum(ref_count - hyp_count, 0).sum()) * resolution
    false_alarm = float(np.maximum(hyp_count - ref_count, 0).sum()) * resolution
    # Confusion: reference speech attributed to the wrong (mapped) speaker,
    # excluding time already counted as missed.
    correct = float((R & mapped).sum()) * resolution
    confusion = max(total - missed - correct, 0.0)

    errors = missed + false_alarm + confusion
    if total > 0:
        der = errors / total
    else:
        # No scored reference speech: DER is undefined (NIST divides by
        # zero). 0.0 only when the hypothesis is also silent; otherwise
        # +inf — reporting hallucinated speech on a silent reference as a
        # perfect 0.0 would rank pure false alarm as the best config.
        der = 0.0 if errors == 0 else float("inf")
    return {"der": der, "missed": missed, "false_alarm": false_alarm,
            "confusion": confusion, "total": total}
