"""Host clustering and activation binarization for diarization (numpy).

A copy of the JAX package's pipeline/clustering.py: the algorithms inside
pyannote's diarization-3.1 pipeline that the reference calls as a black box
(back/api.py:776-792) — hysteresis binarization of frame activations and
agglomerative clustering of speaker embeddings with speaker-count
constraints. The neural scoring runs on the device; this stays on the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

Interval = Tuple[float, float]


def binarize(scores: np.ndarray, frame_hop: float, onset: float = 0.5,
             offset: float = 0.5, min_duration_on: float = 0.0,
             min_duration_off: float = 0.0) -> List[Interval]:
    """Frame activation scores [T] → active intervals (seconds).

    Hysteresis: a region opens when score rises past ``onset`` and closes
    when it falls below ``offset``; then gaps shorter than
    ``min_duration_off`` are filled and regions shorter than
    ``min_duration_on`` dropped (pyannote Binarize semantics).

    Vectorized (the per-frame Python loop was the diarizer's host hotspot:
    ~3.5k frames × VAD + 3 slots × files per engine pass); equivalence to
    the reference loop is asserted in tests. When onset < offset a frame
    can satisfy BOTH thresholds and the outcome is state-dependent — that
    (unusual) configuration keeps the exact loop."""
    scores = np.asarray(scores, np.float32)
    if onset < offset:
        regions = _binarize_loop(scores, frame_hop, onset, offset)
    else:
        rises = scores > onset
        falls = scores < offset
        mark = np.zeros(len(scores), np.int8)
        mark[falls] = -1
        mark[rises] = 1                     # disjoint when onset >= offset
        ev = np.flatnonzero(mark)
        regions = []
        if len(ev):
            st = mark[ev]
            # Collapse runs of identical events: only alternation points
            # change the hysteresis state.
            keep = np.concatenate(([0], np.flatnonzero(np.diff(st)) + 1))
            seq, pos = st[keep], ev[keep]
            if seq[0] == -1:                # falling while already inactive
                seq, pos = seq[1:], pos[1:]
            opens = pos[0::2]
            closes = pos[1::2]
            regions = [(float(o * frame_hop), float(c * frame_hop))
                       for o, c in zip(opens, closes)]
            if len(opens) > len(closes):    # still active at the end
                regions.append((float(opens[-1] * frame_hop),
                                len(scores) * frame_hop))

    if min_duration_off > 0 and regions:
        filled = [regions[0]]
        for s, e in regions[1:]:
            ps, pe = filled[-1]
            if s - pe < min_duration_off:
                filled[-1] = (ps, e)
            else:
                filled.append((s, e))
        regions = filled
    if min_duration_on > 0:
        regions = [(s, e) for s, e in regions if e - s >= min_duration_on]
    return regions


def _binarize_loop(scores: np.ndarray, frame_hop: float, onset: float,
                   offset: float) -> List[Interval]:
    """Reference per-frame hysteresis (pyannote Binarize): the vectorized
    ``binarize`` is tested against this, and it serves the state-dependent
    onset < offset configuration directly."""
    regions: List[Interval] = []
    active = False
    start = 0.0
    for i, s in enumerate(scores):
        t = i * frame_hop
        if not active and s > onset:
            active, start = True, t
        elif active and s < offset:
            regions.append((start, t))
            active = False
    if active:
        regions.append((start, len(scores) * frame_hop))
    return regions


def cosine_distance_matrix(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    norm = np.linalg.norm(x, axis=1, keepdims=True)
    xn = x / np.maximum(norm, 1e-12)
    return 1.0 - xn @ xn.T


def ahc_cluster(embeddings: np.ndarray, threshold: float = 0.7,
                min_clusters: int = 1,
                max_clusters: Optional[int] = None) -> np.ndarray:
    """Average-linkage agglomerative clustering on cosine distance.

    Merges the closest pair until (a) the closest distance exceeds
    ``threshold`` AND the cluster count is ≤ ``max_clusters`` (if set), or
    (b) ``min_clusters`` is reached. Returns integer labels ordered by first
    appearance (cluster 0 contains embedding 0).
    """
    n = len(embeddings)
    if n == 0:
        return np.zeros(0, np.int32)
    if n == 1:
        return np.zeros(1, np.int32)
    dist = cosine_distance_matrix(embeddings)
    np.fill_diagonal(dist, np.inf)

    members: List[List[int]] = [[i] for i in range(n)]
    # Average-linkage distance between current clusters; dead rows/cols
    # pin to +inf instead of re-slicing an active submatrix every merge
    # (re-slicing is O(n^3) with Python-loop constants). Cached per-row
    # minima make each merge O(n)
    # vectorized work plus re-scans only for rows whose cached nearest
    # neighbour was invalidated.
    cd = dist.copy()
    alive = np.ones(n, bool)
    sizes = np.ones(n, np.int64)
    row_min = cd.min(axis=1)
    row_arg = cd.argmin(axis=1)
    n_active = n

    while n_active > max(min_clusters, 1):
        i = int(np.argmin(row_min))
        d = float(row_min[i])
        j = int(row_arg[i])
        over_cap = max_clusters is not None and n_active > max_clusters
        if d > threshold and not over_cap:
            break
        a, b = (i, j) if i < j else (j, i)
        # Average linkage (Lance-Williams) update, vectorized over all
        # columns: +inf entries (self/dead/b) stay +inf under the
        # positive-weighted mean.
        na, nb = sizes[a], sizes[b]
        new = (na * cd[a] + nb * cd[b]) / (na + nb)
        new[a] = np.inf
        cd[a] = new
        cd[:, a] = new
        cd[b, :] = np.inf
        cd[:, b] = np.inf
        members[a].extend(members[b])
        sizes[a] += sizes[b]
        alive[b] = False
        n_active -= 1
        # Refresh cached minima: column a changed for every row, column b
        # died; rows whose cached nearest was a or b re-scan.
        row_min[b] = np.inf
        row_arg[b] = b
        better = cd[:, a] < row_min
        row_min[better] = cd[better, a]
        row_arg[better] = a
        stale = alive & ((row_arg == b) | ((row_arg == a) & ~better))
        stale[a] = True
        for r in np.flatnonzero(stale):
            row_min[r] = cd[r].min()
            row_arg[r] = int(cd[r].argmin())

    labels = np.zeros(n, np.int32)
    order = sorted(np.flatnonzero(alive), key=lambda c: min(members[c]))
    for new_id, c in enumerate(order):
        for idx in members[c]:
            labels[idx] = new_id
    return labels


def cluster_speakers(embeddings: np.ndarray, threshold: float = 0.7,
                     min_speakers: int = 1,
                     max_speakers: Optional[int] = None) -> np.ndarray:
    """Speaker-count-constrained clustering. ``ahc_cluster`` itself keeps
    merging past the threshold while the count exceeds ``max_speakers``
    (its break requires BOTH d > threshold and not over-cap), so the cap
    is already enforced for any min_speakers ≤ max_speakers — this is the
    stable public name the diarizer calls."""
    return ahc_cluster(embeddings, threshold, min_speakers, max_speakers)
