"""The Voxtral cell's parts on the CPU, in a tiny copy of the benchmark
(``helpers.tiny_copy``): the family's draw, fill and readings round trip;
a sound run reads ``correct`` true, and the control (``--control 1``) and
the planted ``altered_token`` read false; the three new metric readers
give numbers in a traced run. The program builds Voxtral at tiny widths
(``models/voxtral.VOXTRALS``) under its published name."""

from __future__ import annotations

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from helpers import TINY_LIMITS, tiny_copy

import run  # after helpers, which puts the benchmark on sys.path
from ccbench.check import check_rng
from ccbench.engine_cell import EngineCell
from ccbench.spec import Cell

SEED = 2**31 + 73
CELL = "tiny-voxtral"
CONFIG = "voxtral-tiny"
# Over three seeds on the CPU (bf16 against the f32 reference, 6 tokens a
# row): sound runs read logprob_gap 7.3e-4-0.022 and logprob_gap_mean
# 1.0e-4-3.1e-3, the control 0.17-0.48 and 0.027-0.072, altered_token
# 2.9-4.2 and 0.46-0.66.
LIMITS = {**TINY_LIMITS, "logprob_gap": 0.05, "logprob_gap_mean": 0.008}
NEW_METRICS = ("voxtral_mfu_pct", "decode.prefix_prefill_share_pct",
               "voxtral_step_roofline")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_voxtral(monkeypatch):
    """The program builds Voxtral at the tiny widths of ``_voxtral_copy``."""
    from clearconverse_tpu_torch.models import voxtral as vx
    dims = vx.VoxtralDims(n_audio_state=64, n_audio_head=2, n_audio_layer=1,
                          d_model=48, n_layer=2, n_head=4, n_kv_head=2,
                          head_dim=16, d_ffn=96, n_vocab=1300)
    monkeypatch.setitem(vx.VOXTRALS, vx.NAME, dims)
    return dims


def _json(path, obj=None):
    if obj is None:
        with open(path) as fh:
            return json.load(fh)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)


def _voxtral_copy(dest: str) -> str:
    """The tiny copy with the Voxtral configuration at tiny widths, one
    12 s file a pass, up to 6 tokens a row, as files and entries."""
    root = tiny_copy(dest)
    b = os.path.join(root, "benchmark")
    cfg = _json(os.path.join(b, "configs", "voxtral-mini-3b-2507.json"))
    cfg["name"] = CONFIG
    cfg["audio_config"].update(hidden_size=64, intermediate_size=256,
                               num_hidden_layers=1, num_attention_heads=2)
    cfg["text_config"].update(hidden_size=48, intermediate_size=96,
                              num_hidden_layers=2, num_attention_heads=4,
                              num_key_value_heads=2, head_dim=16,
                              vocab_size=1300)
    cfg["engine"]["TorchConfig"]["max_decode_tokens"] = 6
    cfg["engine"]["Config"]["transcription_batch_size"] = 4
    _json(os.path.join(b, "configs", CONFIG + ".json"), cfg)
    _json(os.path.join(b, "limits", CELL + ".json"), LIMITS)
    manifest = _json(os.path.join(root, "BENCHMARK.json"))
    manifest["configs"].append({
        "name": CONFIG, "source": "test",
        "file": f"benchmark/configs/{CONFIG}.json", "reduced": [],
        "why": "CPU tests"})
    manifest["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": "files_1_tiny",
        "chips": 1, "why": "CPU tests"})
    for m in manifest["per_layer"]:
        if "voxtral-mini-batch" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    _json(os.path.join(root, "BENCHMARK.json"), manifest)
    return root


def _result(root, trace=0, fault=None, control=0):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", CELL, "--seed", str(SEED),
                       "--seconds", "1", "--trace", str(trace),
                       "--control", str(control)],
                      device="cpu", need_card=False, fault=fault,
                      bench_dir=f"{root}/benchmark", root=root)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def test_the_family_draws_fills_and_reads_back(tmp_path, tiny_voxtral):
    root = _voxtral_copy(str(tmp_path))
    cell = Cell(CELL, f"{root}/benchmark", root)
    fams = cell.families()
    fam = fams["voxtral"]
    ec = EngineCell(cell.config, fams, torch.device("cpu"), str(tmp_path))
    dims = fam.dims(cell.config)
    assert fam.program_dims(ec.engine) == dims
    w = fam.draw(dims, SEED, "cpu")
    fam.fill(ec.engine, w)
    model = ec.engine.models._voxtral[0]
    from clearconverse_tpu_torch.models.convert import voxtral_hf_names
    params = dict(model.named_parameters())
    for hf, pt in voxtral_hf_names(model.dims).items():
        assert params[pt].dtype == w[hf].dtype, hf
        torch.testing.assert_close(params[pt], w[hf], rtol=0, atol=0)
    ref = fam.reference_weights(dims, SEED, "cpu")
    assert all(ref[k].dtype == torch.float32
               and torch.equal(ref[k], w[k].float()) for k in w)
    # The rows checked: CHECKED_REPLICAS of every unique row.
    rows = fam.checked_rows(check_rng(SEED, fam.ROW_STREAM), 4, 5)
    assert len(rows) == 4 * fam.CHECKED_REPLICAS
    assert sorted({r // 5 for r in rows}) == [0, 1, 2, 3]


@pytest.mark.parametrize("mode", ["sound", "control", "altered_token"])
def test_the_voxtral_cell_checks_its_decode(tmp_path, tiny_voxtral, mode):
    root = _voxtral_copy(str(tmp_path))
    res, err = _result(root, control=int(mode == "control"),
                       fault=mode if mode == "altered_token" else None)
    checks = res["checks"]
    assert set(checks) == set(LIMITS)
    assert all(c["value"] is not None for c in checks.values()), checks
    assert "rows" in err and "tokens" in err
    gap = checks["logprob_gap"]
    if mode == "sound":
        assert res["correct"] is True, checks
    else:
        assert res["correct"] is False, checks
        assert gap["value"] > gap["limit"]


def test_the_voxtral_metrics_read_in_a_traced_run(tmp_path, tiny_voxtral):
    root = _voxtral_copy(str(tmp_path))
    res, _ = _result(root, trace=1)
    m = res["metrics"]
    for name in NEW_METRICS + ("decode.step_ms", "decode.window_captures"):
        assert name in m, sorted(m)
    assert 0 < m["decode.prefix_prefill_share_pct"]["value"] < 100
    assert m["voxtral_mfu_pct"]["value"] > 0
    assert m["voxtral_step_roofline"]["value"] > 0
    assert np.isfinite(m["decode.step_ms"]["value"])


def test_the_new_readers_find_nothing_in_a_whisper_run(tmp_path):
    root = tiny_copy(str(tmp_path), program=False)
    cell = Cell("small.en-batch", f"{root}/benchmark", root)
    from clearconverse_tpu_torch.utils.tracing import StageTimer
    timer = StageTimer()
    with timer.stage("token_loop"):
        pass
    timer.count("token_loop_steps", 3)
    run_ = {"window": {"window_s": 1.0}, "k1_window": [(1, 480000, 80)],
            "decode_timer": timer, "dims": {}, "decode_calls": []}
    for name in NEW_METRICS:
        assert cell.reader(name)(run_) is None, name
