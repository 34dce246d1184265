"""The idle split by stage (``engine.speaker_idle_pct``,
``engine.decode_idle_pct``, ``engine.host_idle_pct``) on hand-built traces
with known ranges and busy intervals, and on the host events of a real
profiler trace of the program's spans."""

from __future__ import annotations

import time

import pytest
import torch

from helpers import BENCH_DIR  # noqa: F401  (puts the benchmark on sys.path)

from ccbench.spec import Cell  # noqa: E402
from ccbench.trace import Trace, traced  # noqa: E402

CELL = Cell("small.en-batch")
SPLIT = ("engine.speaker_idle_pct", "engine.decode_idle_pct",
         "engine.host_idle_pct")
READ = {name: CELL.reader(name) for name in SPLIT + ("device.idle_pct",)}
MS = 1_000_000   # ns


def _trace(host, device, window_ms):
    kernels = [(f"k{i}", a * MS, b * MS) for i, (a, b) in enumerate(device)]
    return Trace(window_ms * 1e-3, kernels,
                 [(n, a * MS, b * MS) for n, a, b in host])


def _split(trace):
    return {name: READ[name]({"trace": trace}) for name in READ}


# A pass of 100 ms: load_gate 0-10, segmentation 10-30 (its bundle call
# 12-20 inside), two overlapping per-file separation ranges 40-52 and 48-56
# inside prepare_files 35-60, the decode wavefront 60-90, finalize 90-100.
HOST = [("cc:process_files", 0, 100), ("cc:load_gate", 0, 10),
        ("cc:segmentation", 10, 30), ("cc:bundle.segment_dev", 12, 20),
        ("cc:prepare_files", 35, 60), ("cc:file.separation", 40, 52),
        ("cc:file.separation", 48, 56), ("cc:decode_wavefront", 60, 90),
        ("cc:finalize", 90, 100), ("aten::mm", 61, 62)]
# Busy: 5-15 (5 in load_gate, 5 in segmentation), 25-45 (5 in
# segmentation, 10 in host time 30-40, 5 in separation), 70-80 and 85-88
# (decode), and 95-97 overlapping 96-99 (finalize).
DEVICE = [(5, 15), (25, 45), (70, 80), (85, 88), (95, 97), (96, 99)]


def test_the_split_on_known_ranges_is_exact():
    got = _split(_trace(HOST, DEVICE, 100))
    # Speaker: segmentation 20 ms with 10 busy; separation's union 40-56,
    # 16 ms with 5 busy.
    assert got["engine.speaker_idle_pct"] == pytest.approx(21.0, abs=1e-9)
    # Decode: 30 ms with 13 busy.
    assert got["engine.decode_idle_pct"] == pytest.approx(17.0, abs=1e-9)
    # The rest: 0-10 (5 busy), 30-40 (10 busy), 56-60 (0), 90-100 (4).
    assert got["engine.host_idle_pct"] == pytest.approx(15.0, abs=1e-9)
    assert sum(got[n] for n in SPLIT) == pytest.approx(
        got["device.idle_pct"], abs=1e-9)


def test_idle_outside_the_pass_is_the_remainder():
    # A window of 120 ms: 10 ms before the pass, 10 after; a kernel at
    # 115-118 runs after it.
    host = [(n, a + 10, b + 10) for n, a, b in HOST]
    device = [(a + 10, b + 10) for a, b in DEVICE] + [(115, 118)]
    got = _split(_trace(host, device, 120))
    scale = 100 / 120
    assert got["engine.speaker_idle_pct"] == pytest.approx(21.0 * scale)
    assert got["engine.decode_idle_pct"] == pytest.approx(17.0 * scale)
    assert got["engine.host_idle_pct"] == pytest.approx(15.0 * scale)
    rest = got["device.idle_pct"] - sum(got[n] for n in SPLIT)
    assert rest == pytest.approx(100 * 17 / 120)


def test_nothing_to_read_without_the_pass_range():
    host = [h for h in HOST if h[0] != "cc:process_files"]
    for trace in (_trace(host, DEVICE, 100), _trace(HOST, [], 100)):
        got = _split(trace)
        assert all(got[n] is None for n in SPLIT), got
    assert all(READ[n]({}) is None for n in SPLIT)
    assert all(READ[n]({"trace": None}) is None for n in SPLIT)


def test_the_readers_find_the_programs_ranges_in_a_profiler_trace():
    from clearconverse_tpu_torch.utils.tracing import StageTimer
    run_timer, per_file = StageTimer(), StageTimer(scope="file",
                                                   args={"file": 0})

    def one_pass():
        with StageTimer().stage("process_files"):
            for name in ("load_gate", "segmentation", "prepare_files",
                         "decode_wavefront", "finalize"):
                with run_timer.stage(name):
                    if name == "prepare_files":
                        with per_file.stage("separation"):
                            time.sleep(0.004)
                    time.sleep(0.004)

    _, cpu = traced(one_pass, torch.device("cpu"))
    spans = {n: (a, b) for n, a, b in cpu.host if n.startswith("cc:")}
    assert set(spans) == {"cc:process_files", "cc:load_gate",
                          "cc:segmentation", "cc:prepare_files",
                          "cc:file.separation", "cc:decode_wavefront",
                          "cc:finalize"}
    # The card's trace holds the same host events beside its kernels: one
    # kernel busy through a stage's range leaves that stage no idle time.

    def ms(name):
        a, b = spans[name]
        return (b - a) * 1e-6

    for busy in ("cc:segmentation", "cc:decode_wavefront"):
        a, b = spans[busy]
        got = _split(Trace(cpu.window_s, [("k", a, b)], cpu.host))
        idle_ms = {n: got[n] * cpu.window_s * 10 for n in SPLIT}
        speaker = ms("cc:file.separation") + (
            0.0 if busy == "cc:segmentation" else ms("cc:segmentation"))
        decode = 0.0 if busy == "cc:decode_wavefront" else ms(
            "cc:decode_wavefront")
        assert idle_ms["engine.speaker_idle_pct"] == pytest.approx(
            speaker, abs=1e-6)
        assert idle_ms["engine.decode_idle_pct"] == pytest.approx(
            decode, abs=1e-6)
        assert sum(idle_ms.values()) == pytest.approx(
            ms("cc:process_files") - ms(busy), abs=1e-6)
