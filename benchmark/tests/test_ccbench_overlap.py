"""The overlap cell's parts on the CPU, in a tiny copy of the benchmark
(``helpers.tiny_copy``): its three families record what the window runs
and read ``correct`` true; the planted ``altered_source`` turns it false;
and the kind writes every file's overlap where its mix puts it. The
separator keeps the published layout at tiny widths, and Whisper is
tiny.en's."""

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
from ccbench.spec import Cell

SEED = 2**31 + 61
CELL = "tiny-overlap"
LIMITS = {**TINY_LIMITS, "sep_gap": 1e-4}
SEP = {"N_encoder_out": 16, "out_channels": 16, "nhead": 2, "d_ffn": 32,
       "num_layers": 1}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _json(path, obj=None):
    if obj is None:
        with open(path) as fh:
            return json.load(fh)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)


def _overlap_copy(dest: str) -> str:
    """The tiny copy with the overlap configuration at tiny.en's and tiny
    separator widths, one 30 s file a pass, as files and entries."""
    root = tiny_copy(dest)
    b = os.path.join(root, "benchmark")
    tiny = _json(os.path.join(b, "configs", "whisper-tiny.en.json"))
    cfg = _json(os.path.join(b, "configs", "resepformer-wsj02mix.json"))
    for k in ("program_model", "d_model", "encoder_layers", "decoder_layers",
              "encoder_attention_heads", "decoder_attention_heads",
              "encoder_ffn_dim", "decoder_ffn_dim"):
        cfg[k] = tiny[k]
    cfg["name"] = "resepformer-tiny"
    cfg["engine"]["TorchConfig"]["max_decode_tokens"] = 8
    cfg["engine"]["Config"]["transcription_batch_size"] = 4
    cfg["resepformer"].update(SEP)
    _json(os.path.join(b, "configs", "resepformer-tiny.json"), cfg)
    mix = _json(os.path.join(b, "traffic", "files_64x30s_ov40.json"))
    mix.update(files_per_pass=1, pool_passes=1, warm_passes=1)
    _json(os.path.join(b, "traffic", "files_1_ov40.json"), mix)
    _json(os.path.join(b, "limits", CELL + ".json"), LIMITS)
    manifest = _json(os.path.join(root, "BENCHMARK.json"))
    manifest["configs"].append({
        "name": "resepformer-tiny", "source": "test",
        "file": "benchmark/configs/resepformer-tiny.json", "reduced": [],
        "why": "CPU tests"})
    manifest["workloads"].append({
        "name": CELL, "config": "resepformer-tiny", "traffic": "files_1_ov40",
        "chips": 1, "why": "CPU tests"})
    for m in manifest["per_layer"]:
        if "small.en-overlap" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    _json(os.path.join(root, "BENCHMARK.json"), manifest)
    return root


@pytest.fixture
def tiny_separator(monkeypatch):
    """The program builds the published layout at the tiny widths."""
    from clearconverse_tpu_torch.models import resepformer as rsf
    dims = rsf.ResepformerDims(enc_channels=16, n_heads=2, d_ffn=32,
                               n_layers=1)
    monkeypatch.setitem(rsf.SEPARATORS, "resepformer-wsj02mix", dims)
    return dims


def _result(root, trace=0, fault=None):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", CELL, "--seed", str(SEED),
                       "--seconds", "1", "--trace", str(trace)],
                      device="cpu", need_card=False, fault=fault,
                      bench_dir=f"{root}/benchmark", root=root)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("fault", [None, "altered_source"])
def test_the_overlap_cell_separates_and_checks_it(tmp_path, tiny_separator,
                                                  fault):
    root = _overlap_copy(str(tmp_path))
    res, err = _result(root, fault=fault)
    checks = res["checks"]
    assert set(checks) == set(LIMITS)
    assert all(c["value"] is not None for c in checks.values()), checks
    assert "sep_rows" in err
    sep = checks["sep_gap"]
    if fault is None:
        assert res["correct"] is True, checks
        assert sep["value"] < sep["limit"]
    else:
        assert res["correct"] is False
        assert sep["value"] > 0.1
        assert all(c["value"] <= c["limit"] for k, c in checks.items()
                   if k != "sep_gap")


def test_the_overlap_cells_metrics_read_in_a_traced_run(tmp_path,
                                                        tiny_separator):
    root = _overlap_copy(str(tmp_path))
    res, _ = _result(root, trace=1)
    m = res["metrics"]
    for name in ("engine.separation_share_pct", "sepformer_mfu_pct",
                 "separation.pad_pct"):
        assert name in m, sorted(m)
    assert 0 < m["engine.separation_share_pct"]["value"] < 100
    assert 0 < m["sepformer_mfu_pct"]["value"] < 100
    assert 0 < m["separation.pad_pct"]["value"] < 100


def test_the_kind_writes_the_overlap_of_every_turn(tmp_path):
    root = tiny_copy(str(tmp_path), program=False)
    cell = Cell("small.en-overlap", f"{root}/benchmark", root)
    kind, mix = cell.kind(), dict(cell.traffic)
    mix.update(files_per_pass=1, pool_passes=1)
    path = kind.generate(mix, SEED, str(tmp_path))["pool"][0][0]
    import wave
    with wave.open(path) as fh:
        x = np.frombuffer(fh.readframes(fh.getnframes()), "<i2") / 32767.0
    sr, turn = 16000, mix["turn_seconds"]
    assert x.size == mix["file_seconds"] * sr

    def level(t0, hz):
        seg = x[int(t0 * sr): int((t0 + 0.5) * sr)]
        spec = np.abs(np.fft.rfft(seg)) / seg.size
        f = np.fft.rfftfreq(seg.size, 1 / sr)
        return spec[np.abs(f - hz) < 20].max()

    for t0 in range(0, mix["file_seconds"], turn):
        for t in np.arange(0.0, turn, 0.5):
            low, high = level(t0 + t, 300), level(t0 + t, 2000)
            assert (low > 0.1) == (0.0 <= t and t + 0.5 <= 10.0), (t0, t)
            assert (high > 0.1) == (4.0 <= t and t + 0.5 <= 14.5), (t0, t)
