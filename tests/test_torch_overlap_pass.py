"""The engine's overlap path runs once a ``process_files`` pass: every
file's resegmentation windows share one embedding call, every file's
overlap spans share duration-bucketed separation batches of 16 rows, and
every file's separated sources share one embedding call.

On the CPU with the tiny published separator (``test_torch_resepformer``'s
bundle): each file's result equals that file through ``process_file``
alone; the separator is called once per 16 rows of a bucket, not once per
file; the counters match the calls; and the fallbacks — a failed
separation call, a failed shared resegmentation, a fatal error, a pass
without overlap."""

import math

import numpy as np
import pytest
import torch

from clearconverse_tpu_torch.audio.wav import write_wav
from clearconverse_tpu_torch.pipeline.batching import pick_bucket
from clearconverse_tpu_torch.pipeline.dev_backend import (
    HIGH, LOW, SR, synth_conversation)
from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine
from test_torch_resepformer import _bundle

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conversation(overlap_s: float, lead_s: float = 0.0) -> np.ndarray:
    """L(0-3), H(3.5-6), then both for ``overlap_s`` from 6.6 s, after
    ``lead_s`` of silence."""
    t = np.arange(int((lead_s + 7.1 + overlap_s) * SR)) / SR
    low = 0.5 * np.sin(2 * np.pi * LOW * t)
    high = 0.5 * np.sin(2 * np.pi * HIGH * t)

    def g(a, b):
        return ((t >= a + lead_s) & (t < b + lead_s)).astype(np.float32)
    both = g(6.6, 6.6 + overlap_s)
    return (low * (g(0, 3) + both) + high * (g(3.5, 6) + both)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Four files whose overlap spans land in the 5 s and the 10 s
    buckets: the synthetic conversation, a copy 1 s later, a 7 s overlap
    and a 3 s one after 0.5 s of silence."""
    d = tmp_path_factory.mktemp("overlap_pass")
    waves = {"conv": synth_conversation(),
             "later": np.concatenate([np.zeros(SR, np.float32),
                                      synth_conversation()]),
             "long": _conversation(7.0),
             "lead": _conversation(3.0, lead_s=0.5)}
    out = {}
    for name, wave in waves.items():
        out[name] = str(d / f"{name}.wav")
        write_wav(out[name], wave, SR)
    return out


class Recorder:
    """Records the bundle's separation calls (rows, padded samples,
    lengths) and the embedding calls made inside the engine's
    resegmentation and source phases; ``fail`` (a predicate on a call's
    padded batch) makes a separation call raise ``error``."""

    def __init__(self, eng):
        self.sep, self.embeds = [], {"reseg": 0, "source": 0}
        self.fail, self.error = None, RuntimeError("separator failed")
        self.phase = None
        b = eng.models
        separate = b.separate_batch

        def separate_batch(audio, lengths=None):
            if self.fail is not None and self.fail(audio):
                raise self.error
            self.sep.append((np.shape(audio), [int(n) for n in lengths]))
            return separate(audio, lengths)
        b.separate_batch = separate_batch
        for name in ("embed_batch", "embed_store"):
            self._count(b, name)
        for name, phase in (("_resegment_overlaps", "reseg"),
                            ("_best_sources", "source")):
            self._within(eng, name, phase)

    def _count(self, b, name):
        fn = getattr(b, name)

        def counted(*args, **kwargs):
            if self.phase is not None:
                self.embeds[self.phase] += 1
            return fn(*args, **kwargs)
        setattr(b, name, counted)

    def _within(self, eng, name, phase):
        fn = getattr(eng, name)

        def within(*args, **kwargs):
            self.phase = phase
            try:
                return fn(*args, **kwargs)
            finally:
                self.phase = None
        setattr(eng, name, within)

    def clear(self):
        self.sep.clear()
        self.embeds.update(reseg=0, source=0)


def _engine():
    b = _bundle()
    eng = TranscriptionEngine(config=b.config, torch_config=b.torch_config,
                              models=b)
    return eng, Recorder(eng)


def _view(result):
    return [(s.start, s.end, s.speaker_id, s.is_overlap)
            for s in result["segments"]]


def _assert_same(got, want):
    assert got is not None and want is not None
    assert _view(got) == _view(want)
    for a, b in zip(got["segments"], want["segments"]):
        assert abs(a.confidence - b.confidence) <= TOL
        assert a.audio.shape == b.audio.shape
        peak = max(float(np.abs(b.audio).max()), 1e-12)
        assert float(np.abs(a.audio - b.audio).max()) <= TOL * peak


@pytest.fixture(scope="module")
def alone(files):
    """Each file through process_file alone, with its separation calls."""
    eng, rec = _engine()
    out = {}
    for name, path in files.items():
        rec.clear()
        out[name] = (eng.process_file(path), list(rec.sep))
    return out


@pytest.fixture(scope="module")
def shared(files):
    """One pass over 13 files (the four, then three of them three times
    more): 24 spans in the 5 s bucket, 2 in the 10 s one."""
    eng, rec = _engine()
    names = list(files) + ["conv", "later", "lead"] * 3
    results = eng.process_files([files[n] for n in names])
    return names, results, eng, rec


def test_each_file_equals_the_file_alone(alone, shared):
    names, results, _, _ = shared
    assert all(r is not None for r in results)
    for name, res in zip(names, results):
        _assert_same(res, alone[name][0])
        assert any(s.is_overlap for s in res["segments"]), name
    # Alone, every file with overlap makes its own calls.
    assert all(alone[name][1] for name in alone)


def test_the_pass_separates_in_shared_batches_of_16(shared):
    names, results, _, rec = shared
    per_bucket = {}
    for res in results:
        for s in res["segments"]:
            if s.is_overlap:
                b = pick_bucket(len(s.audio) / SR, (5.0, 10.0, 30.0))
                per_bucket[b] = per_bucket.get(b, 0) + 1
    assert len(per_bucket) >= 2 and max(per_bucket.values()) > 16
    want = sum(math.ceil(n / 16) for n in per_bucket.values())
    assert len(rec.sep) == want < len(names)
    assert all(shape[0] <= 16 for shape, _ in rec.sep)
    assert sorted(n for _, lens in rec.sep for n in lens) == sorted(
        len(s.audio) for res in results for s in res["segments"]
        if s.is_overlap)


def test_the_counters_match_the_calls(shared):
    _, _, eng, rec = shared
    c = eng.last_run_separation
    assert c["calls"] == len(rec.sep)
    assert c["real_rows"] == sum(shape[0] for shape, _ in rec.sep)
    assert c["real_samples"] == sum(sum(lens) for _, lens in rec.sep)
    assert c["rows"] >= c["real_rows"] and c["segments"] > 0
    # One call of windows and one of sources a bucket, for all 13 files.
    assert c["reseg_calls"] == rec.embeds["reseg"] >= 1
    assert c["source_calls"] == rec.embeds["source"] >= 1
    assert c["reseg_calls"] + c["source_calls"] <= 4
    st = eng.last_run_stage_times
    for key in ("overlap_reseg", "separation", "source_embeds"):
        assert st["prepare_files." + key] > 0


def test_a_failed_separation_call_keeps_only_its_spans_mixed(files, alone):
    """The 10 s bucket's call fails: its spans (file "long") keep their
    mixed clips at confidence 0, as that file alone with a failing
    separator; every other file equals itself alone."""
    eng, rec = _engine()
    rec.fail = lambda audio: np.shape(audio)[1] == 10 * SR
    names = list(files)
    got = eng.process_files([files[n] for n in names])
    assert all(r is not None for r in got)
    assert rec.sep and all(shape[1] == 5 * SR for shape, _ in rec.sep)
    rec.fail = lambda audio: True
    mixed = eng.process_file(files["long"])
    assert [s.confidence for s in mixed["segments"] if s.is_overlap] == \
        [0.0, 0.0]
    for name, res in zip(names, got):
        _assert_same(res, mixed if name == "long" else alone[name][0])


def test_a_failed_shared_resegmentation_sends_each_file_its_own_way(
        files, alone, monkeypatch):
    eng, rec = _engine()
    shared_reseg = eng._resegment_overlaps

    def failing(jobs, sr):
        if len(jobs) > 1:
            raise ValueError("shared resegmentation failed")
        return shared_reseg(jobs, sr)
    monkeypatch.setattr(eng, "_resegment_overlaps", failing)
    names = list(files)
    got = eng.process_files([files[n] for n in names])
    for name, res in zip(names, got):
        _assert_same(res, alone[name][0])
    # Each file separated its own spans, as alone.
    assert len(rec.sep) == sum(len(alone[n][1]) for n in names)
    c = eng.last_run_separation
    assert c["reseg_calls"] == len(names) and c["calls"] == len(rec.sep)


@pytest.mark.parametrize("where", ["separation", "resegmentation"])
def test_a_fatal_error_propagates(files, where):
    eng, rec = _engine()
    fatal = NotImplementedError("an unported path")
    if where == "separation":
        rec.fail, rec.error = (lambda audio: True), fatal
    else:
        def failing(jobs, sr):
            raise fatal
        eng._resegment_overlaps = failing
    with pytest.raises(NotImplementedError):
        eng.process_files([files["conv"], files["long"]])


def test_a_pass_without_overlap_makes_no_overlap_call(tmp_path):
    eng, rec = _engine()
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"plain{i}.wav"))
        write_wav(paths[-1], synth_conversation()[: (8 + i) * SR], SR)
    got = eng.process_files(paths)
    assert all(r is not None and r["segments"] for r in got)
    assert not any(s.is_overlap for r in got for s in r["segments"])
    assert rec.sep == [] and rec.embeds == {"reseg": 0, "source": 0}
    c = eng.last_run_separation
    assert c["calls"] == c["reseg_calls"] == c["source_calls"] == 0
