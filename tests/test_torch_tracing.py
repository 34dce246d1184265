"""The port's ``utils/tracing``: ``StageTimer`` spans and counts, and the
``cc:`` profiler ranges its spans open while ``torch.profiler`` runs: their
names, nesting and file indexes over an engine pass (a tiny Whisper, a tiny
ECAPA and the crafted PyanNet on one short file), a top-level stage around
every model call, nothing opened with the profiler off or inside a graph
capture, and the decode program's ranges without a timer."""

import logging
import os
from typing import Dict, List, Tuple

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clearconverse_tpu_torch.utils import tracing
from clearconverse_tpu_torch.utils.tracing import StageTimer

torch.set_num_threads(1)

# The substrings the benchmark's roofline metrics match kernel names on.
KERNEL_NAMES = ("mel_power_kernel", "attention_bf16_kernel",
                "attention_f32_kernel")
TOP = ("load_gate", "make_store", "segmentation", "diarize_cluster",
       "profiles", "plan_files", "segment_embeds", "prepare_files", "merge",
       "decode_wavefront", "finalize")


def test_stage_timer_spans_and_counts():
    timer = StageTimer()
    with timer.stage("a"):
        pass
    with timer.stage("a"):
        with timer.stage("b"):
            pass
    timer.count("steps", 3)
    timer.count("steps")
    assert set(timer.as_dict()) == {"a", "b"}
    assert [name for name, _ in timer.spans] == ["a", "b", "a"]
    assert timer.counts == {"steps": 4}
    totals = StageTimer(totals_only=True)
    with totals.stage("x"):
        pass
    assert totals.spans == [] and list(totals.as_dict()) == ["x"]


class Event:
    def __init__(self, ev):
        self.name = ev.name()
        self.a = ev.start_ns()
        self.b = self.a + ev.duration_ns()
        self.thread = ev.start_thread_id()
        self.kw = dict(ev.kwinputs())

    def inside(self, other: "Event") -> bool:
        return other.a <= self.a and self.b <= other.b


def _profiled(fn) -> Tuple[object, List[Event]]:
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        out = fn()
    return out, [Event(e) for e in p.profiler.kineto_results.events()]


def _ranges(events, prefix=tracing.RANGE_PREFIX):
    return [e for e in events if e.name.startswith(prefix)]


def _tiny_bundle():
    from clearconverse_tpu_torch.config import TorchConfig
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.ecapa import EcapaDims, init_ecapa
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.models.whisper import WhisperDims
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        craft_pyannet_freq_params)
    dims = WhisperDims(n_audio_state=64, n_audio_head=2, n_audio_layer=1,
                       n_text_state=64, n_text_head=2, n_text_layer=1)
    b = ModelBundle(torch_config=TorchConfig(max_decode_tokens=4, best_of=2),
                    device="cpu")
    b._whisper = (init_whisper(dims, 0, "cpu"), dims, ByteFallbackTokenizer())
    edims = EcapaDims(n_mels=24, channels=32, mfa_channels=48,
                      attention_channels=16, embedding_dim=16,
                      res2net_scale=4)
    b._ecapa, b._ecapa_dims = init_ecapa(edims, 1, "cpu"), edims
    b._pyannet, b._pyannet_dims = craft_pyannet_freq_params(device="cpu")
    b._loaded = True
    return b


@pytest.fixture(scope="module")
def engine_and_paths(tmp_path_factory):
    from clearconverse_tpu_torch.audio.wav import write_wav
    from clearconverse_tpu_torch.pipeline.dev_backend import synth_conversation
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine
    b = _tiny_bundle()
    d = tmp_path_factory.mktemp("tracing")
    paths = []
    for i in range(2):
        paths.append(os.path.join(d, f"short{i}.wav"))
        write_wav(paths[-1], synth_conversation()[: (8 + i) * 16000], 16000)
    eng = TranscriptionEngine(torch_config=b.torch_config, models=b)
    eng.process_files(paths)                   # untraced first pass
    return eng, paths


@pytest.fixture(scope="module")
def probed_pass(engine_and_paths):
    """One pass under the profiler with every public method of the bundle
    and the engine's ``_finalize`` wrapped in a ``probe:`` range."""
    eng, paths = engine_and_paths
    bundle = eng.models
    saved = {}

    def probe(obj, name):
        fn = getattr(obj, name)

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function("probe:" + name):
                return fn(*args, **kwargs)
        saved[(obj, name)] = fn
        setattr(obj, name, wrapped)

    for name in dir(type(bundle)):
        attr = getattr(type(bundle), name)
        if not name.startswith("_") and callable(attr):
            probe(bundle, name)
    probe(eng, "_finalize")
    try:
        results, events = _profiled(lambda: eng.process_files(paths))
    finally:
        for (obj, name) in saved:
            delattr(obj, name)
    assert all(r is not None and r["segments"] for r in results), results
    return eng, events


def _top_level(events):
    """The ranges directly under ``cc:process_files``."""
    ranges = _ranges(events)
    pf, = [e for e in ranges if e.name == "cc:process_files"]
    inner = [e for e in ranges if e is not pf and e.inside(pf)]
    return pf, [e for e in inner
                if not any(o is not e and e.inside(o) for o in inner)]


def test_a_pass_names_its_stages_by_level(probed_pass):
    eng, events = probed_pass
    ranges = _ranges(events)
    names = {e.name for e in ranges}
    pf, top = _top_level(events)
    assert sorted({e.name for e in top}) == sorted("cc:" + k for k in TOP)
    # Every range is inside the pass and on its thread.
    assert all(e.inside(pf) for e in ranges)
    assert {e.thread for e in ranges} == {pf.thread}
    for sub in ("file.load_audio", "file.vad", "file.diarization",
                "file.profiles", "file.segment_embeddings",
                "file.overlap_reseg", "file.separation", "bundle.embed_dev",
                "bundle.segment_dev", "bundle.decode_dev", "decode.gather",
                "decode.log_mel", "decode.encoder", "decode.cross_kv",
                "decode.prefill", "decode.token_loop"):
        assert "cc:" + sub in names, (sub, sorted(names))
    assert not [n for n in names for k in KERNEL_NAMES if k in n]

    def parents(e):
        return {o.name for o in top if e.inside(o)}
    for e in ranges:
        if e.name.startswith("cc:file."):
            assert parents(e) <= {"cc:plan_files", "cc:prepare_files"}, e.name
            assert parents(e)
        if e.name.startswith("cc:decode."):
            assert any(e.inside(o) for o in ranges
                       if o.name == "cc:bundle.decode_dev"), e.name
            assert parents(e) == {"cc:decode_wavefront"}, e.name
    # The overlap path runs once for the pass: its two ranges keep their
    # per-file names, sit in cc:prepare_files and carry no file index;
    # every other per-file range carries its file's index.
    shared = ("cc:file.overlap_reseg", "cc:file.separation")
    for name in shared:
        found = [e for e in ranges if e.name == name]
        assert len(found) == 1, (name, len(found))
        assert parents(found[0]) == {"cc:prepare_files"} and not found[0].kw
    files = [e for e in ranges
             if e.name.startswith("cc:file.") and e.name not in shared]
    assert {e.kw.get("file") for e in files} == {0, 1}
    assert all(not e.kw for e in ranges if not e.name.startswith("cc:file."))
    # The stages the pass records are the top-level ranges, and the
    # shares' fixed keys are still there.
    st = eng.last_run_stage_times
    assert {k for k in st if "." not in k} == set(TOP)
    assert {"prepare_files.overlap_reseg", "prepare_files.separation",
            "prepare_files.source_embeds"} <= set(st)
    assert sum(st[k] for k in TOP) <= (pf.b - pf.a) * 1e-9


def test_every_model_call_runs_under_a_top_level_stage(probed_pass):
    _, events = probed_pass
    pf, top = _top_level(events)
    probes = [e for e in events if e.name.startswith("probe:")]
    called = {e.name[len("probe:"):] for e in probes}
    for name in ("make_store", "segment_frames_store", "embed_frames_store",
                 "embed_store", "transcribe_batch", "_finalize"):
        assert name in called, sorted(called)
    for e in probes:
        assert e.inside(pf), e.name
        assert any(e.inside(t) for t in top), e.name


def test_no_range_with_the_profiler_off(engine_and_paths, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range with the profiler off")
    monkeypatch.setattr(tracing, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(tracing, "_open_range", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    eng, paths = engine_and_paths
    assert all(r is not None for r in eng.process_files(paths))
    timer = StageTimer(sync=True, scope="x", args={"file": 0})
    with timer.stage("a"):
        pass
    assert list(timer.as_dict()) == ["a"]
    _decode_call()


def test_no_range_inside_a_graph_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    timer = StageTimer()

    def spans():
        with timer.stage("a"):
            pass
    _, events = _profiled(spans)
    assert _ranges(events) == []
    assert list(timer.as_dict()) == ["a"]


def test_range_names_scope_and_args():
    timer = StageTimer(scope="file", args={"file": 7})

    def spans():
        with timer.stage("vad"):
            with timer.stage("token_loop", scope="decode"):
                pass
        with StageTimer().stage("top"):
            pass
    _, events = _profiled(spans)
    got = {e.name: e.kw for e in _ranges(events)}
    assert got == {"cc:file.vad": {"file": 7},
                   "cc:decode.token_loop": {"file": 7}, "cc:top": {}}
    # The recorded keys carry no scope.
    assert sorted(timer.as_dict()) == ["token_loop", "vad"]


def _decode_call(timer=None):
    from clearconverse_tpu_torch.models.decoding import (
        DecodeOptions, greedy_decode_from_audio)
    b = _tiny_bundle()
    model, dims, _ = b._whisper
    audio = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 16000)).astype(np.float32) * 0.1)
    prompt = torch.tensor([[50257], [50257]])
    opts = DecodeOptions(max_tokens=4, temperature=0.0,
                         compute_dtype=torch.float32)
    return greedy_decode_from_audio(model, audio, prompt, torch.tensor([1, 1]),
                                    dims, opts, 4, timer=timer)


DECODE = ("log_mel", "encoder", "cross_kv", "prefill", "token_loop")


def test_decode_ranges_without_a_timer_leave_the_result_alone():
    plain = _decode_call()
    traced, events = _profiled(_decode_call)
    names = [e.name for e in _ranges(events)]
    assert sorted(names) == sorted("cc:decode." + k for k in DECODE)
    _same(plain, traced)
    # With a timer the spans keep their keys and the same ranges.
    timer = StageTimer(sync=True)
    timed, events = _profiled(lambda: _decode_call(timer))
    assert sorted(e.name for e in _ranges(events)) == sorted(names)
    assert set(timer.as_dict()) == set(DECODE)
    assert timer.counts["token_loop_steps"] >= 1
    _same(plain, timed)


def _same(a: Dict, b: Dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("level,calls", [(logging.WARNING, 0),
                                         (logging.INFO, 1)])
def test_finalize_builds_its_summary_only_when_logged(level, calls,
                                                      monkeypatch):
    from clearconverse_tpu_torch.pipeline import engine as E
    made = []
    monkeypatch.setattr(StageTimer, "summary",
                        lambda self: made.append(1) or "")
    eng = E.TranscriptionEngine.__new__(E.TranscriptionEngine)
    prep = {"items": [], "timer": StageTimer(), "duration": 1.0,
            "meta_counts": {}, "mapping": {}}
    before = E.logger.level
    E.logger.setLevel(level)
    try:
        out = eng._finalize(prep)
    finally:
        E.logger.setLevel(before)
    assert out["segments"] == [] and len(made) == calls


def _stage_ns(loops: int, timer: StageTimer) -> float:
    import time
    t0 = time.perf_counter_ns()
    for _ in range(loops):
        with timer.stage("x"):
            pass
    return (time.perf_counter_ns() - t0) / loops


def test_a_span_records_a_total_with_the_profiler_on_and_off():
    timer = StageTimer(totals_only=True)
    _stage_ns(10, timer)
    _profiled(lambda: _stage_ns(10, timer))
    assert timer.spans == [] and list(timer.as_dict()) == ["x"]
    assert timer.as_dict()["x"] > 0.0


def _voxtral_bundle():
    """``_tiny_bundle`` with a tiny Voxtral (models/voxtral.py) as its
    transcriber."""
    from clearconverse_tpu_torch.config import Config
    from clearconverse_tpu_torch.models import voxtral as vx
    from clearconverse_tpu_torch.models.tokenizer import (
        TekkenByteTokenizer, TekkenSpecials)
    b = _tiny_bundle()
    b.config = Config(whisper_model_size=vx.NAME)
    dims = vx.VoxtralDims(n_audio_state=64, n_audio_head=2, n_audio_layer=1,
                          d_model=32, n_layer=1, n_head=4, n_kv_head=2,
                          head_dim=8, d_ffn=64, n_vocab=1300)
    b._whisper = None
    b._voxtral = (vx.init_voxtral(dims, 0, "cpu", torch.float32), dims,
                  TekkenByteTokenizer(TekkenSpecials(n_vocab=dims.n_vocab)))
    return b


def test_voxtral_decode_opens_its_ranges_and_adds_up_its_counters(
        tmp_path, monkeypatch):
    from clearconverse_tpu_torch.audio.wav import write_wav
    from clearconverse_tpu_torch.models import decoding
    from clearconverse_tpu_torch.pipeline.dev_backend import synth_conversation
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine
    b = _voxtral_bundle()
    eng = TranscriptionEngine(b.config, b.torch_config, models=b)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"v{i}.wav"))
        write_wav(paths[-1], synth_conversation()[: (8 + i) * 16000], 16000)
    calls = []
    real = decoding.voxtral_decode_from_audio

    def counted(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(out["counts"])
        return out

    monkeypatch.setattr(decoding, "voxtral_decode_from_audio", counted)
    eng.process_files(paths)                   # a pass before the traced one
    calls.clear()
    results, events = _profiled(lambda: eng.process_files(paths))
    assert all(r is not None and r["segments"] for r in results), results
    names = {e.name for e in _ranges(events)}
    assert {"cc:decode.adapter", "cc:decode.prefix_prefill",
            "cc:decode.encoder", "cc:decode.token_loop"} <= names
    assert "cc:decode.cross_kv" not in names
    # The pass's counters are its calls' sums (prefix copies: the most).
    assert calls
    want = {k: sum(c[k] for c in calls) for k in calls[0]}
    want["prefix_copies"] = 1
    assert b.last_decode == want
    assert want["rows"] == 2 * want["prefix_rows"]
