"""Whole runs on the CPU at a tiny size: the harness's look for a card is
skipped and everything else runs, the program's models included. A sound
run comes out correct; one with an answer altered where a model produced
it does not, nor one with the control (the reference one precision below
the configuration's) in the program's place; and the control reads above
the limits that sound runs stay under. A traffic kind added as a file runs
with no edit to the harness."""

from __future__ import annotations

import contextlib
import io
import json
import os

import pytest
import torch

from helpers import TINY, TINY_LIMITS, tiny_copy

import control  # after helpers, which puts the benchmark on sys.path
import run


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _result(root, fault=None, trace=0, ctl=0, workload=TINY):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(2**31 + 21),
                       "--seconds", "1", "--trace", str(trace),
                       "--control", str(ctl)],
                      device="cpu", need_card=False, fault=fault,
                      bench_dir=f"{root}/benchmark", root=root)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [None, "altered_token", "altered_scores",
                                   "altered_embedding"])
def test_a_run_is_correct_unless_an_answer_is_broken(tmp_path, fault):
    root = tiny_copy(str(tmp_path))
    res = _result(root, fault, trace=0 if fault else 1)
    assert res["correct"] is (fault is None)
    assert list(res)[-1] == "checks"
    assert {k: c["limit"] for k, c in res["checks"].items()} == TINY_LIMITS
    assert all(c["value"] is not None for c in res["checks"].values())
    assert res["attempted"] >= 1 and res["failed"] == 0
    if fault is None:
        assert set(res["metrics"]) >= {"engine.decode_share_pct",
                                       "decode.step_ms", "whisper_mfu_pct"}
        assert "breakdown" in res
    else:
        broken = {"altered_token": "logprob_gap",
                  "altered_scores": "seg_logprob_gap",
                  "altered_embedding": "embed_gap"}[fault]
        c = res["checks"][broken]
        assert c["value"] > c["limit"]


def test_the_control_in_the_programs_place_is_not_correct(tmp_path):
    res = _result(tiny_copy(str(tmp_path)), ctl=1)
    assert res["correct"] is False
    over = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert set(over) >= {"logprob_gap", "seg_logprob_gap", "embed_gap"}


def test_the_control_reads_above_the_limits(tmp_path, capsys):
    root = tiny_copy(str(tmp_path))
    control.main(["--workload", TINY, "--seeds", "5,6", "--seconds", "1",
                  "--control"], device="cpu", bench_dir=f"{root}/benchmark",
                 root=root)
    for line in capsys.readouterr().out.strip().splitlines():
        r = json.loads(line)
        assert r["rows"] > 0 and r["seg_rows"] > 0 and r["embed_rows"] > 0
        for name in ("logprob_gap", "seg_logprob_gap", "embed_gap"):
            assert r["numbers"][name] < TINY_LIMITS[name] < r["control"][name]


# A traffic kind of its own: one file a unit, through ``engine.run``.
ONE_FILE_KIND = '''
import time
from ccbench import traffic


def generate(mix, seed, out_dir):
    import numpy as np, os
    rng = np.random.default_rng(seed)
    path = os.path.join(out_dir, "one.wav")
    traffic.write_wav(path, traffic.make_file(rng, mix["file_seconds"], 0.01))
    return {"path": path}


def unit(ec, mix, inputs):
    return ec.engine.process_files([inputs["path"]])


def warm(ec, mix, inputs):
    unit(ec, mix, inputs)


def window(ec, mix, inputs, seconds):
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        n += sum(r is not None for r in unit(ec, mix, inputs))
    span = time.perf_counter() - t0
    return {"window_s": span, "attempted": n, "failed": 0, "units": n,
            "values": {"rtfx": n * mix["file_seconds"] / span}}
'''


def test_a_kind_added_as_a_file_runs_with_no_edit(tmp_path):
    root = tiny_copy(str(tmp_path))
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "kinds", "one_file.py"), "w") as fh:
        fh.write(ONE_FILE_KIND)
    with open(os.path.join(b, "traffic", "one_file_tiny.json"), "w") as fh:
        json.dump({"kind": "one_file", "file_seconds": 12, "check_calls": 2}, fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    manifest["workloads"].append({"name": "tiny-one", "config": "whisper-tiny.en",
                                  "traffic": "one_file_tiny", "chips": 1,
                                  "why": "CPU tests"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(manifest, fh)
    with open(os.path.join(b, "limits", "tiny-one.json"), "w") as fh:
        json.dump(TINY_LIMITS, fh)
    res = _result(root, workload="tiny-one")
    assert res["correct"] is True
    assert res["metrics"]["rtfx"]["value"] > 0
