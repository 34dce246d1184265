"""The port's host copies of pipeline/clustering.py and pipeline/batching.py
against the JAX package's, on the same seeded inputs: identical segments
from ``binarize`` (and its per-frame reference loop) across thresholds and
min-duration passes, identical AHC labels with and without speaker-count
constraints, the same cosine distances, and the same buckets, batches and
splits. The scenarios of tests/test_segments.py that cover these modules
run on the port's functions too.
"""

import numpy as np
import pytest

from clearconverse_tpu.pipeline import batching as jb
from clearconverse_tpu.pipeline import clustering as jc

from clearconverse_tpu_torch.pipeline import batching as tb
from clearconverse_tpu_torch.pipeline import clustering as tc


@pytest.mark.parametrize("seed", range(4))
def test_binarize_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for trial in range(50):
        n = int(rng.integers(0, 400))
        scores = rng.random(n).astype(np.float32)
        onset, offset = float(rng.random()), float(rng.random())
        fhop = float(rng.uniform(0.005, 0.05))
        if n and trial % 3 == 0:
            scores[::5] = np.float32(onset)
        for kw in ({}, {"min_duration_on": 0.05, "min_duration_off": 0.03}):
            assert tc.binarize(scores, fhop, onset, offset, **kw) == \
                jc.binarize(scores, fhop, onset, offset, **kw)
        assert tc._binarize_loop(scores, fhop, onset, offset) == \
            jc._binarize_loop(scores, fhop, onset, offset)


@pytest.mark.parametrize("seed", range(4))
def test_ahc_and_cluster_speakers_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(30):
        n = int(rng.integers(1, 40))
        k = int(rng.integers(1, 5))
        emb = (np.repeat(rng.standard_normal((k, 16)), n, axis=0)[:n]
               + rng.standard_normal((n, 16)) * 0.3).astype(np.float32)
        np.testing.assert_array_equal(tc.cosine_distance_matrix(emb),
                                      jc.cosine_distance_matrix(emb))
        th = float(rng.uniform(0.1, 1.3))
        mn = int(rng.integers(1, 3))
        mx = None if rng.random() < 0.5 else int(rng.integers(1, 5))
        np.testing.assert_array_equal(tc.ahc_cluster(emb, th, mn, mx),
                                      jc.ahc_cluster(emb, th, mn, mx))
        kw = dict(threshold=th, min_speakers=mn, max_speakers=mx)
        np.testing.assert_array_equal(tc.cluster_speakers(emb, **kw),
                                      jc.cluster_speakers(emb, **kw))


def test_binarize_scenarios_of_test_segments():
    scores = np.array([0.1, 0.9, 0.9, 0.6, 0.2, 0.1, 0.9, 0.9, 0.1])
    assert tc.binarize(scores, frame_hop=0.1, onset=0.8, offset=0.3) == [
        (pytest.approx(0.1), pytest.approx(0.4)),
        (pytest.approx(0.6), pytest.approx(0.8))]
    scores = np.array([0.9] * 5 + [0.0] + [0.9] * 5 + [0.0] * 5 + [0.9])
    out = tc.binarize(scores, 0.1, 0.5, 0.5, min_duration_on=0.3,
                      min_duration_off=0.2)
    assert out == [(pytest.approx(0.0), pytest.approx(1.1))]


def test_ahc_scenarios_of_test_segments(rng):
    a = rng.standard_normal(16) + 5
    b = rng.standard_normal(16) - 5
    embs = np.stack([a + 0.01 * rng.standard_normal(16) for _ in range(5)]
                    + [b + 0.01 * rng.standard_normal(16) for _ in range(5)])
    labels = tc.ahc_cluster(embs, threshold=0.5)
    assert len(set(labels[:5])) == 1 and len(set(labels[5:])) == 1
    assert labels[0] != labels[5] and labels[0] == 0
    assert tc.cluster_speakers(rng.standard_normal((6, 8)), threshold=0.0,
                               max_speakers=2).max() + 1 <= 2
    c = rng.standard_normal(8)
    same = np.stack([c + 1e-4 * rng.standard_normal(8) for _ in range(4)])
    assert tc.ahc_cluster(same, threshold=0.5, min_clusters=1).max() + 1 == 1


@pytest.mark.parametrize("seed", range(3))
def test_batch_audio_matches_jax(seed):
    rng = np.random.default_rng(200 + seed)
    sr, buckets = 100, (1.0, 2.5, 5.0)
    clips = [rng.standard_normal(int(rng.integers(1, 700))).astype(np.float32)
             for _ in range(int(rng.integers(1, 20)))]
    for d in (0.0, 0.3, 1.0, 2.6, 9.0):
        assert tb.pick_bucket(d, buckets) == jb.pick_bucket(d, buckets)
    for batch_size in (1, 4, 8):
        ours = list(tb.batch_audio(clips, sr, buckets, batch_size))
        ref = list(jb.batch_audio(clips, sr, buckets, batch_size))
        assert len(ours) == len(ref)
        for o, r in zip(ours, ref):
            assert len(o) == len(r)
            for x, y in zip(o, r):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_split_long_matches_jax():
    sr = 10
    short = np.arange(200, dtype=np.float32)
    out = tb.split_long(short, sr, 30.0)
    assert len(out) == 1 and out[0] is short
    longer = np.arange(650, dtype=np.float32)
    ours, ref = tb.split_long(longer, sr, 30.0), jb.split_long(longer, sr, 30.0)
    assert [len(c) for c in ours] == [len(c) for c in ref] == [300, 300, 50]
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)
