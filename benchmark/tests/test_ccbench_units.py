"""CPU tests of the benchmark's parts: traffic, the window's accounting,
the roofline arithmetic, finding parts by name, and isolation from JAX
and from the program."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import time

import pytest

from helpers import BENCH_DIR, ROOT, TINY_LIMITS, tiny_copy


import torch  # noqa: E402

from ccbench import roofline, speaker_reference, weights  # noqa: E402
from ccbench.spec import Cell, readers  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "clearconverse_tpu"}
MIX = {"kind": "closed_loop_files", "files_per_pass": 2, "file_seconds": 3,
       "noise_sigma": 0.01, "pool_passes": 2}


KIND = Cell("small.en-batch").kind()


def _pool_bytes(tmp_path, seed, name):
    out = tmp_path / name
    out.mkdir()
    return [open(p, "rb").read() for paths in
            KIND.generate(MIX, seed, str(out))["pool"] for p in paths]


def test_traffic_is_deterministic_in_the_seed(tmp_path):
    a = _pool_bytes(tmp_path, 2**31 + 5, "a")
    b = _pool_bytes(tmp_path, 2**31 + 5, "b")
    c = _pool_bytes(tmp_path, 2**31 + 6, "c")
    assert a == b
    assert all(x != y for x, y in zip(a, c))
    assert len(a) == 4 and len(set(a)) == 4
    # Every seed asks for the same sizes.
    assert [len(x) for x in a] == [len(x) for x in c]


class _FakeEngine:
    def __init__(self, pass_s):
        self.pass_s = pass_s
        self.last_run_stage_times = {}

    def process_files(self, paths):
        time.sleep(self.pass_s)
        self.last_run_stage_times = {"decode_wavefront": self.pass_s / 2}
        return [{"segments": [1]}] + [None] * (len(paths) - 1)


class _FakeCell:
    engine = None


def test_rtfx_counts_all_completed_work_to_the_last_completion():
    ec = _FakeCell()
    ec.engine = _FakeEngine(0.05)
    inputs = {"pool": [["a", "b"]], "next": 0}
    win = KIND.window(ec, {**MIX, "file_seconds": 30}, inputs, 0.12)
    n = len(win["passes"])
    assert n >= 3                      # the pass started inside runs out
    assert win["window_s"] >= 0.12     # the last completion is inside
    assert win["attempted"] == 2 * n and win["failed"] == n
    assert win["values"]["rtfx"] == pytest.approx(n * 30.0 / win["window_s"],
                                                  rel=1e-12)
    assert win["window_s"] == pytest.approx(
        sum(p["wall"] for p in win["passes"]), rel=0.05)


def test_kernel_bounds_equal_chip_smoke_phase_2():
    # PERF.md's kernel table: K1 0.0071 ms (bytes), K2 0.0559 ms
    # (operations) at B = 8 rows of 30 s, small.en's 12 heads.
    assert roofline.k1_bound_s(8, 480000, 80) * 1e3 == pytest.approx(0.0071, abs=5e-5)
    assert roofline.k2_bound_s(8, 1500, 12) * 1e3 == pytest.approx(0.0559, abs=5e-5)
    moved, _ = roofline.k1_work(8, 480000, 80)
    assert moved == 4 * (8 * 480000 + 8 * 3000 * 80 + 2 * 400 * 201 + 201 * 80)


SMALL = {"num_mel_bins": 80, "d_model": 768, "encoder_ffn_dim": 3072,
         "decoder_ffn_dim": 3072, "encoder_layers": 12, "decoder_layers": 12,
         "max_source_positions": 1500, "vocab_size": 51864}
TURBO = {"num_mel_bins": 128, "d_model": 1280, "encoder_ffn_dim": 5120,
         "decoder_ffn_dim": 5120, "encoder_layers": 32, "decoder_layers": 4,
         "max_source_positions": 1500, "vocab_size": 51866}


@pytest.mark.parametrize("dims,per_row", [
    # conv1 + conv2 + layers x (q, k, v, out, fc1, fc2 + QK^T and PV)
    (SMALL, 2 * 80 * 768 * 3 * 3000 + 2 * 768 * 768 * 3 * 1500
     + 12 * (2 * 1500 * (4 * 768 * 768 + 2 * 768 * 3072)
             + 2 * 2 * 1500 * 1500 * 768)),
    (TURBO, 2 * 128 * 1280 * 3 * 3000 + 2 * 1280 * 1280 * 3 * 1500
     + 32 * (2 * 1500 * (4 * 1280 * 1280 + 2 * 1280 * 5120)
             + 2 * 2 * 1500 * 1500 * 1280)),
])
def test_encoder_flops_hand_count(dims, per_row):
    assert roofline.encoder_flops(dims, 3) == 3 * per_row
    # The published sizes: about 0.34 and 2.27 TFLOP a 30 s row.
    assert per_row == pytest.approx(0.344e12 if dims is SMALL else 2.274e12,
                                    rel=5e-3)


@pytest.mark.parametrize("dims", [SMALL, TURBO])
def test_decoder_flops_hand_count(dims):
    d, f, L, V = (dims["d_model"], dims["decoder_ffn_dim"],
                  dims["decoder_layers"], dims["vocab_size"])
    # One token at context c: self q, k, v, out; cross q, out; fc1, fc2;
    # attention over c tokens and 1500 frames; the vocabulary logits.
    def token(c):
        return L * (2 * (6 * d * d + 2 * d * f) + 4 * d * c + 4 * d * 1500) + 2 * d * V
    prompt, steps = 5, 7
    hand = sum(token(c) for c in range(1, prompt + steps + 1))
    assert roofline.decode_call_flops(dims, [prompt, prompt], steps) == \
        pytest.approx(2 * hand, rel=1e-12)
    assert roofline.cross_kv_flops(dims, 2) == 2 * L * 2 * 1500 * 2 * d * d


def test_a_timestamp_decode_is_refused():
    rec = {"beam": False, "timestamp_begin": 50364}
    whisper = Cell("small.en-batch").families()["whisper"]
    with pytest.raises(ValueError, match="timestamp"):
        whisper.whisper_readings([rec], SMALL, {})


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -12), 3.0e-3])
    got = speaker_reference.to_tf32(x)
    assert got[0] == 1.0 + 2.0 ** -10          # representable
    assert got[1] == 1.0                       # a tie goes to even
    assert got[2] == 1.0 + 2.0 ** -9           # a tie goes to even
    assert got[3] == -1.0
    assert abs(float(got[4]) / 3.0e-3 - 1) < 2.0 ** -11


PYANNET = {"sinc_filters": 80, "sinc_kernel": 251, "sinc_stride": 10,
           "conv_channels": 60, "conv_kernel": 5, "pool": 3, "lstm_hidden": 128,
           "lstm_layers": 2, "linear_dims": [128, 128], "n_classes": 7,
           "powerset": True, "sample_rate": 16000}
ECAPA = {"n_mels": 80, "channels": 64, "mfa_channels": 192,
         "attention_channels": 16, "embedding_dim": 24, "res2net_scale": 8,
         "dilations": [2, 3, 4]}


def test_the_speaker_references_agree_with_the_program_in_float32():
    # The yardstick and the program, given the same weights and audio,
    # agree to float32 rounding; at TF32 they do not.
    from clearconverse_tpu_torch.models import ecapa, pyannet
    torch.manual_seed(0)
    audio = 0.1 * torch.randn(3, 16000)
    w = weights.make_weights(weights.pyannet_spec(PYANNET), 2**31 + 3, "cpu",
                             "pyannet", weights.f32)
    prog = pyannet.init_pyannet(pyannet.PyannetDims(), 0, "cpu")
    weights.fill_tree(prog, w)
    got = pyannet.pyannet_forward(prog, audio)
    ref = speaker_reference.pyannet_logprobs(w, PYANNET, audio)
    low = speaker_reference.pyannet_logprobs(w, PYANNET, audio, tf32=True)
    assert float((got - ref).abs().max()) < 1e-4 < float((low - ref).abs().max())
    dims = ecapa.EcapaDims(channels=64, mfa_channels=192, attention_channels=16,
                           embedding_dim=24)
    w = weights.make_weights(weights.ecapa_spec(ECAPA), 2**31 + 3, "cpu",
                             "ecapa", weights.f32)
    prog = ecapa.init_ecapa(dims, 0, "cpu")
    weights.fill_tree(prog, w)
    lens = torch.tensor([16000, 9000, 4000])
    got = ecapa.ecapa_embed(prog, audio, lens, dims)
    ref = speaker_reference.ecapa_embeddings(w, ECAPA, audio, lens)
    low = speaker_reference.ecapa_embeddings(w, ECAPA, audio, lens, tf32=True)
    rel = ((got - ref).norm(dim=1) / ref.norm(dim=1)).max()
    rel_low = ((low - ref).norm(dim=1) / ref.norm(dim=1)).max()
    assert float(rel) < 1e-5 < float(rel_low)


def test_speaker_weights_cover_the_programs_trees():
    from clearconverse_tpu_torch.models import ecapa, pyannet
    prog = pyannet.init_pyannet(pyannet.PyannetDims(), 0, "cpu")
    spec = weights.pyannet_spec(PYANNET)
    assert {n: s for n, s, _ in spec} == {
        n: tuple(t.shape) for n, t in weights.flat(prog).items()}
    prog = ecapa.init_ecapa(ecapa.EcapaDims(), 0, "cpu")
    spec = weights.ecapa_spec({**ECAPA, "channels": 512, "mfa_channels": 1536,
                               "attention_channels": 128, "embedding_dim": 192})
    assert {n: s for n, s, _ in spec} == {
        n: tuple(t.shape) for n, t in weights.flat(prog).items()}


def test_parts_added_as_files_are_found_by_name(tmp_path):
    root = tiny_copy(str(tmp_path), program=False)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "metrics", "demo.rows.py"), "w") as fh:
        fh.write("def read(run):\n    return float(len(run['passes']))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    manifest["per_layer"].append({
        "name": "demo.rows", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "Engine", "moves": "rtfx",
        "workloads": ["tiny-batch"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(manifest, fh)
    cell = Cell("tiny-batch", b, root)
    assert cell.config["program_model"] == "tiny.en"
    assert cell.traffic["file_seconds"] == 12
    assert cell.limits == TINY_LIMITS
    assert cell.kind().__name__.endswith("closed_loop_files")
    assert [m["name"] for m in cell.end_to_end()] == ["rtfx", "setup_s"]
    got = readers(cell)
    assert got["demo.rows"]({"passes": [1, 2, 3]}) == 3.0
    # Every reader of the real manifest is found, and one with nothing to
    # read returns nothing.
    for name, read in got.items():
        if name != "demo.rows":
            assert read({"dims": SMALL}) is None, name


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources():
    for d, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("name", ["reference.py", "speaker_reference.py",
                                  "weights.py", "check.py", "roofline.py",
                                  "traffic.py"])
def test_the_yardstick_imports_nothing_of_the_program(name):
    tops = {m.split(".")[0] for m in
            _imports(os.path.join(BENCH_DIR, "ccbench", name))}
    assert "clearconverse_tpu_torch" not in tops


def test_a_process_of_the_harness_holds_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from ccbench import check, engine_cell, record, reference, roofline, "
        "spec, speaker_reference, trace, traffic, weights\n"
        "import run, control\n"
        "spec.Cell('small.en-batch').kind()\n"
        "spec.Cell('small.en-batch').families()\n"
        "from clearconverse_tpu_torch.pipeline import engine, bundle\n"
        "print(run.forbidden_loaded())\n" % (BENCH_DIR, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    import run
    before = run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "clearconverse_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    monkeypatch.setitem(sys.modules, "flaxen.sub", object())
    assert run.forbidden_loaded() == before
    monkeypatch.setitem(sys.modules, "clearconverse_tpu.models", object())
    assert "clearconverse_tpu" in run.forbidden_loaded()


def _run_cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "small.en-batch",
         "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = _run_cli(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_directory_with_only_the_benchmark_fails(tmp_path):
    root = tiny_copy(str(tmp_path), program=False)
    code = ("import sys; sys.path.insert(0, 'benchmark'); import run; "
            "raise SystemExit(run.main(['--workload', 'tiny-batch', '--seed', "
            "'1', '--seconds', '1'], device='cpu', need_card=False))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
