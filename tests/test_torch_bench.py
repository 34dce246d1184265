"""The port's bench (``python -m clearconverse_tpu_torch.bench``) and
``entry()`` on the CPU at tiny sizes: the bench prints a flushed hot-path
line first and a merged last line under 2,000 characters with every block's
keys, on a tiny dress-rehearsal directory (so ``random_weights`` is false);
``entry()`` at 2 layers of small.en width agrees with the root
``__graft_entry__.entry()`` forward on carried-across params at f32."""

import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from clearconverse_tpu.models import whisper as jw

from clearconverse_tpu_torch import bench
from clearconverse_tpu_torch.entry import entry
from clearconverse_tpu_torch.eval import dress_rehearsal as dr
from clearconverse_tpu_torch.models.convert import whisper_from_jax_params
from clearconverse_tpu_torch.models.whisper import model_dims

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINE_BLOCK_KEYS = {"rtfx_warm_best", "rtfx_warm_mean", "warm_passes",
                     "per_pass_s", "step_ms", "launches", "peak_mem_gb"}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def test_bench_lines_on_a_tiny_rehearsal_set(tmp_path, capsys):
    models = tmp_path / "models"
    dr.populate(str(models), tiny=True, device="cpu")
    rc = bench.main(["--device", "cpu", "--model", "tiny.en", "--batch", "2",
                     "--decode-tokens", "4", "--iters", "1",
                     "--engine-files", "1", "--engine-repeats", "1",
                     "--engine-tiles", "1", "--latency-repeats", "1",
                     "--model-dir", str(models)])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    first, last = json.loads(lines[0]), json.loads(lines[-1])
    assert first["engine"] == {"status": "pending"}
    assert len(lines[-1]) < 2000
    assert last["metric"] == "whisper_tiny_en_rtfx" and last["value"] > 0
    assert last["card"] == "cpu" and last["models"] == "present"
    hot = last["hot_path"]
    assert hot["batch"] == 2 and hot["decode_tokens"] == 4
    assert hot["kv_bits"] == 8 and hot["step_ms"] > 0
    assert set(hot["stage_ms"]) >= {"log_mel", "encoder", "cross_kv",
                                    "prefill"}
    # Kernels launch only on the card; the CPU runs their plain versions.
    assert hot["launches"] == {"k1": 0, "k2": 0}
    for key in ("engine", "engine_ref_default", "engine_overlap"):
        assert ENGINE_BLOCK_KEYS <= set(last[key]), (key, last[key])
        assert last[key]["rtfx_warm_best"] > 0
    knobs = last["engine"]["knobs"]
    assert knobs["random_weights"] is False
    assert set(knobs["load_source"].values()) == {"checkpoint",
                                                  "BPETokenizer"}
    for key in ("engine_ref_default", "engine_overlap"):
        assert "stage_seconds" not in last[key]
    assert last["engine_overlap"]["random_weights"] is False
    assert last["engine_overlap"]["overlap_segments_per_pass"] > 0
    assert last["latency"]["latency_best_s"] > 0


def test_bench_skip_engine_prints_one_line(tmp_path, capsys):
    rc = bench.main(["--device", "cpu", "--model", "tiny.en", "--batch", "1",
                     "--decode-tokens", "2", "--iters", "1", "--kv-bits", "4",
                     "--skip-engine"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["hot_path"]["kv_bits"] == 4 and "engine" not in line


def test_bench_refuses_cuda_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--skip-engine"]) == 2
    assert capsys.readouterr().out == ""


def test_sig_rounds_to_three_significant_places():
    got = bench._sig({"a": 123.456, "b": [0.0012345, 7], "c": 0.0,
                      "d": float("inf"), "e": "x"})
    assert got == {"a": 123.0, "b": [0.00123, 7], "c": 0.0,
                   "d": float("inf"), "e": "x"}


class _FakeEngine:
    """process_files records the decode timer it ran under."""

    def __init__(self):
        self.models = type("Bundle", (), {"decode_timer": None})()
        self.timers = []
        self.last_run_stage_times = {"decode_wavefront": 0.01}

    def process_files(self, paths):
        self.timers.append(self.models.decode_timer)
        timer = self.models.decode_timer
        if timer is not None:
            with timer.stage("token_loop"):
                timer.count("token_loop_steps", 4)
        return [{"segments": []} for _ in paths]


@pytest.mark.parametrize("stages", [True, False])
def test_timed_passes_run_without_the_decode_timer(stages):
    """The timed passes carry no synchronising spans: the step time comes
    from one more pass, the only one with the decode timer set."""
    eng = _FakeEngine()
    out, _ = bench._timed_passes(eng, ["a.wav"], 2, float("inf"), 60.0,
                                 torch.device("cpu"), stages=stages)
    assert eng.timers[:2] == [None, None] and len(eng.timers) == 3
    assert eng.timers[2] is not None and eng.models.decode_timer is None
    assert out["warm_passes"] == 2 and out["step_ms"] >= 0
    assert ("stage_seconds" in out) is stages


def test_entry_matches_graft_entry_at_f32(monkeypatch):
    """Both entries at 2 layers of small.en width, in f32: the JAX forward
    with ``model_dims`` and its bf16 patched for the call, the port's with
    ``dims`` and ``dtype``; the port runs on the JAX init's params."""
    spec = importlib.util.spec_from_file_location(
        "_graft_entry", ROOT / "__graft_entry__.py")
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    jdims = dataclasses.replace(jw.model_dims("small.en"), n_audio_layer=2,
                                n_text_layer=2)
    monkeypatch.setattr(jw, "model_dims", lambda size: jdims)
    monkeypatch.setattr(jnp, "bfloat16", jnp.float32)
    jfwd, (params, jmel, jtokens) = graft.entry()
    ref = np.asarray(jfwd(params, jmel, jtokens))

    tdims = dataclasses.replace(model_dims("small.en"), n_audio_layer=2,
                                n_text_layer=2)
    fwd, (_, mel, tokens) = entry(dims=tdims, dtype=torch.float32,
                                  device="cpu")
    np.testing.assert_array_equal(mel.numpy(), np.asarray(jmel))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    model = whisper_from_jax_params(jax.tree.map(np.asarray, params), tdims,
                                    "cpu")
    out = fwd(model, mel, tokens)
    assert out.shape == ref.shape == (1, 21, 51864)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-4)


def test_entry_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
