"""The port's eval package (clearconverse_tpu_torch/eval) against the JAX
package's: WER, DER, the Hungarian mapping and the English normaliser give
identical outputs on every case of tests/test_eval.py and
tests/test_normalize_en.py (one parametrised case each); the sweep CLI and
the parity CLI with ``--levers`` on the dev stand-ins
(``CC_TPU_FAKE_MODELS=1``) write the same artifacts, time and RTFx fields
aside."""

import csv
import itertools
import json

import numpy as np
import pytest

from clearconverse_tpu.eval import der as jder
from clearconverse_tpu.eval import harness as jharness
from clearconverse_tpu.eval import normalize_en as jnorm
from clearconverse_tpu.eval import parity as jparity
from clearconverse_tpu.eval import wer as jwer
from clearconverse_tpu.eval.__main__ import main as jeval_main

from clearconverse_tpu_torch.audio.wav import write_wav
from clearconverse_tpu_torch.eval import der as tder
from clearconverse_tpu_torch.eval import harness as tharness
from clearconverse_tpu_torch.eval import normalize_en as tnorm
from clearconverse_tpu_torch.eval import parity as tparity
from clearconverse_tpu_torch.eval import wer as twer
from clearconverse_tpu_torch.eval.__main__ import main as teval_main
from clearconverse_tpu_torch.pipeline.dev_backend import SR, synth_conversation

from test_normalize_en import PAIRS

# ------------------------------------------------------------------- WER

WER_CASES = [
    ("hello world", "hello world", {}),
    ("a b c d", "a x c", {}),
    ("a b", "a x b", {}),
    ("Hello, world.", "hello world", {}),
    ("The colour is twenty-three", "the color is 23", {}),
    ("", "", {}),
    ("", "a b", {}),
    ("the colour", "the color", {}),
    ("the colour", "the color", {"language": "en"}),
    ("the colour", "the color", {"language": "de"}),
    ("the colour", "the color", {"language": "de", "style": "english"}),
    *[("the colour", "the color", {"language": lang}) for lang in
      ("EN", "English", "en-US", "en_GB", " en ", "DE", "fr-CA", "zh")],
    ("um", "one", {}),
    ("um", " ".join(["word"] * 500), {}),
    ("a b c d", "a x c d e", {}),
    ("hello", "'hello", {}),
    ("hello world", "'hello world'", {}),
    ("don't", "don't", {}),
    ("dont", "don't", {}),
]


@pytest.mark.parametrize("ref,hyp,kw", WER_CASES)
def test_wer_and_detail_equal_jax(ref, hyp, kw):
    assert twer.word_error_rate(ref, hyp, **kw) == jwer.word_error_rate(
        ref, hyp, **kw)
    assert twer.word_error_rate_detail(ref, hyp, **kw) == \
        jwer.word_error_rate_detail(ref, hyp, **kw)


@pytest.mark.parametrize("text,style", [
    ("Hello, World! don't", "english"), ("Hello, World! don't", "light"),
    ("dont", "light"), ("don't", "light")])
def test_normalize_text_equal_jax(text, style):
    assert twer.normalize_text(text, style=style) == jwer.normalize_text(
        text, style=style)


def test_edit_ops_equal_jax():
    ref, hyp = ["a", "b", "c", "d"], ["a", "x", "c"]
    assert twer.edit_ops(ref, hyp) == jwer.edit_ops(ref, hyp)


# ------------------------------------------------------------------- DER

DER_CASES = [
    ([(0.0, 10.0, "A")], [(-0.1, 10.0, "A")], 0.0),
    ([(0.0, 5.0, "A"), (5.0, 10.0, "B")], [(0.0, 5.0, "A"), (5.0, 10.0, "B")],
     0.0),
    ([(0.0, 5.0, "A"), (5.0, 10.0, "B")],
     [(0.0, 5.0, "spk2"), (5.0, 10.0, "spk1")], 0.0),
    ([(0.0, 10.0, "A")], [(0.0, 5.0, "A")], 0.0),
    ([(0.0, 5.0, "A")], [(0.0, 10.0, "A")], 0.0),
    ([(0.0, 5.0, "A"), (5.0, 10.0, "B")], [(0.0, 7.5, "X"), (7.5, 10.0, "Y")],
     0.0),
    ([(0.0, 5.0, "A")], [(0.1, 5.1, "A")], 0.0),
    ([(0.0, 5.0, "A")], [(0.1, 5.1, "A")], 0.25),
    ([(0, 10, "A"), (10, 20, "B"), (20, 30, "C")],
     [(10, 20, "Y"), (20, 30, "X")], 0.0),
    ([], [(0, 10, "X")], 0.0),
    ([], [], 0.0),
    ([(float(i), float(i + 1), f"R{i}") for i in range(12)],
     [(float(i), float(i + 1), f"H{(i * 5) % 12}") for i in range(12)], 0.0),
    # test_der_on_synthetic_diarization's reference against a hypothesis of
    # the dev diarizer's shape.
    ([(0.0, 3.0, "L"), (3.5, 6.0, "H"), (6.2, 8.9, "L"), (9.5, 11.5, "L"),
      (9.5, 11.5, "H")],
     [(0.05, 3.02, "SPEAKER_A"), (3.48, 6.1, "SPEAKER_B"),
      (6.2, 9.0, "SPEAKER_A"), (9.4, 11.6, "SPEAKER_A"),
      (9.6, 11.5, "SPEAKER_B")], 0.25),
]


@pytest.mark.parametrize("ref,hyp,collar", DER_CASES)
def test_der_equal_jax(ref, hyp, collar):
    assert tder.diarization_error_rate(ref, hyp, collar=collar) == \
        jder.diarization_error_rate(ref, hyp, collar=collar)


def _hungarian_matrices():
    rng = np.random.default_rng(7)
    mats = []
    for _ in range(50):
        n, m = int(rng.integers(1, 6)), int(rng.integers(1, 6))
        mats.append(rng.integers(0, 100, size=(n, m)))
    return mats + [np.array([[10, 9, 0], [9, 0, 0], [0, 0, 1]])]


@pytest.mark.parametrize("score", _hungarian_matrices())
def test_hungarian_equal_jax_and_optimal(score):
    got = tder.hungarian_max(score)
    assert got == jder.hungarian_max(score)
    n, m = score.shape
    if n <= m:
        best = max(sum(score[i, p[i]] for i in range(n))
                   for p in itertools.permutations(range(m), n))
    else:
        best = max(sum(score[p[j], j] for j in range(m))
                   for p in itertools.permutations(range(n), m))
    assert sum(score[i, j] for i, j in got.items()) == best


# ------------------------------------------------------------- normaliser

NORM_TEXTS = [src for src, _ in PAIRS] + [
    "onetime wonders", "a second opinion"]


@pytest.mark.parametrize("text", NORM_TEXTS)
def test_text_normalizer_equal_jax(text):
    ours, ref = tnorm.EnglishTextNormalizer(), jnorm.EnglishTextNormalizer()
    assert ours(text) == ref(text)
    assert ours(ours(text)) == ref(ref(text))


@pytest.mark.parametrize("text", [
    "sixty six", "nine hundred ninety nine", "one billion", "four score",
    "zero", "point five"])
def test_number_normalizer_equal_jax(text):
    assert tnorm.EnglishNumberNormalizer()(text) == \
        jnorm.EnglishNumberNormalizer()(text)


@pytest.mark.parametrize("text,extra", [
    *[(w, None) for w in ("surprise", "exercise", "promise", "wise", "rise",
                          "practice", "advertise", "compromise", "precise")],
    ("whisky colour", {"whisky": "whiskey"}),
    ("monologue epilogues dialogue catalogues", None)])
def test_spelling_normalizer_equal_jax(text, extra):
    assert tnorm.EnglishSpellingNormalizer(extra=extra)(text) == \
        jnorm.EnglishSpellingNormalizer(extra=extra)(text)


def test_spelling_from_file_equal_jax(tmp_path):
    p = tmp_path / "english.json"
    p.write_text(json.dumps({"whisky": "whiskey", "colour": "KOLOR",
                             "cosier": "cozier"}), encoding="utf-8")
    text = "whisky cosier colour theatre"
    assert tnorm.EnglishSpellingNormalizer.from_file(str(p))(text) == \
        jnorm.EnglishSpellingNormalizer.from_file(str(p))(text)
    p.write_text('["not", "a", "dict"]', encoding="utf-8")
    for mod in (tnorm, jnorm):
        with pytest.raises(ValueError):
            mod.EnglishSpellingNormalizer.from_file(str(p))


def test_env_spelling_asset_equal_jax(tmp_path, monkeypatch):
    p = tmp_path / "english.json"
    p.write_text(json.dumps({"zorbly": "zorblee"}), encoding="utf-8")
    monkeypatch.setenv("CC_TPU_SPELLING_JSON", str(p))
    assert tnorm.EnglishTextNormalizer()("Zorbly colour!") == \
        jnorm.EnglishTextNormalizer()("Zorbly colour!") == "zorblee color"
    monkeypatch.setenv("CC_TPU_SPELLING_JSON", str(tmp_path / "missing.json"))
    for mod in (tnorm, jnorm):
        with pytest.raises(FileNotFoundError):
            mod.EnglishTextNormalizer()


def test_remove_symbols_equal_jax():
    text = "50% off, $3! café"
    for keep in ("", "%$"):
        assert tnorm.remove_symbols_and_diacritics(text, keep=keep) == \
            jnorm.remove_symbols_and_diacritics(text, keep=keep)


# ------------------------------------------------------ harness and parity

def test_sweep_grid_equal_jax():
    assert tharness.build_sweep_grid() == jharness.build_sweep_grid()
    assert tharness.build_sweep_grid(limit=5) == jharness.build_sweep_grid(
        limit=5)


def test_inf_der_artifacts_equal_jax(tmp_path):
    outs = {}
    for name, mod in (("port", tharness), ("jax", jharness)):
        d = tmp_path / name
        d.mkdir()
        mod._write_artifacts(d, [mod.RunResult(
            "a.wav", 0, {}, "text", 1.0, 0.5, 2.0, wer=None,
            der=float("inf"))])
        outs[name] = {f: (d / f).read_text() for f in (
            "evaluation.csv", "results_summary.json",
            "transcript_comparison.html")}
    assert outs["port"] == outs["jax"]


_TIMES = {"wall_s", "rtfx"}


def _csv_rows(path):
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    col = rows[0].index("RTFx")
    return [r[:col] + r[col + 1:] for r in rows]


def test_sweep_cli_artifacts_equal_jax(tmp_path, monkeypatch, capsys):
    """``python -m ...eval --audio_file x --yes --limit 3`` on the dev
    stand-ins with a ground-truth text, in both packages."""
    wav = tmp_path / "conv.wav"
    write_wav(str(wav), synth_conversation(), SR)
    gt = tmp_path / "gt.txt"
    gt.write_text("low speech 29 high speech")
    monkeypatch.setenv("CC_TPU_FAKE_MODELS", "1")
    outs = {}
    for name, main in (("port", teval_main), ("jax", jeval_main)):
        out = tmp_path / name
        argv = ["--audio_file", str(wav), "--yes", "--limit", "3",
                "--gt-text", str(gt), "--output_dir", str(out)]
        if name == "port":
            argv += ["--device", "cpu"]
        assert main(argv) == 0
        assert "done: 3 runs" in capsys.readouterr().out
        summary = json.loads((out / "results_summary.json").read_text())
        outs[name] = ([{k: v for k, v in r.items() if k not in _TIMES}
                       for r in summary], _csv_rows(out / "evaluation.csv"))
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][0]) == 3
    assert any("[SPEAKER_" in r["transcript"] for r in outs["port"][0])
    assert outs["port"][0][0]["wer"] is not None


def test_parse_transcript_and_rttm_equal_jax(tmp_path):
    text = ("[SPEAKER_A] 0.00s - 3.00s\nlow speech\n\n"
            "[SPEAKER_B] 3.50s - 6.00s\nhigh speech\n")
    assert tparity.parse_transcript(text) == jparity.parse_transcript(text)
    p = tmp_path / "r.rttm"
    p.write_text("SPEAKER f 1 0.50 2.25 <NA> <NA> spk_a <NA> <NA>\n"
                 "garbage line\n"
                 "SPEAKER f 1 3.00 1.00 <NA> <NA> spk_b <NA> <NA>\n")
    assert tparity.parse_rttm(str(p)) == jparity.parse_rttm(str(p))


def _strip_times(obj):
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items()
                if "rtfx" not in k}
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


def test_parity_cli_with_levers_equal_jax(tmp_path, monkeypatch, capsys):
    """``python -m ...eval.parity --levers`` on the dev stand-ins against
    the dev engine's own recorded transcript: WER 0 / DER 0 at the base
    row, the same report as the JAX recipe's (RTFx aside; the port's
    carries no RTFx target), whose lever rows the port's two levers
    match."""
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.pipeline.dev_backend import DevModels
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

    eval_set = tmp_path / "set"
    eval_set.mkdir()
    wav = eval_set / "conv.wav"
    write_wav(str(wav), synth_conversation(), SR)
    res = TranscriptionEngine(Config(noise_reduction_amount=0.0),
                              TorchConfig(), models=DevModels(),
                              device="cpu").process_file(str(wav))
    (eval_set / "conv.ref.txt").write_text("".join(
        f"[{s.speaker_id}] {s.start:.2f}s - {s.end:.2f}s\n{s.transcription}\n\n"
        for s in res["segments"]))
    monkeypatch.setenv("CC_TPU_FAKE_MODELS", "1")
    outs = {}
    for name, main in (("port", tparity.main), ("jax", jparity.main)):
        out = tmp_path / name
        assert main(["--eval-set", str(eval_set), "--out", str(out),
                     "--levers"]) == 0
        brief = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        full = json.loads((tmp_path / f"{name}.json").read_text())
        full.pop("north_star")
        outs[name] = (_strip_times(brief), _strip_times(full))
        assert "Opt-in perf levers" in (tmp_path / f"{name}.md").read_text()
    port_brief = outs["port"][0]
    assert port_brief["mean_wer"] == 0.0 and port_brief["mean_der"] == 0.0
    assert list(port_brief["levers"]) == ["cross_kv_int4", "bucketed_window"]
    for name in ("cross_kv_int4", "bucketed_window"):
        assert port_brief["levers"][name]["delta_wer"] == 0.0
        assert port_brief["levers"][name]["delta_der"] == 0.0
    outs["port"][0].pop("north_star")
    outs["jax"][0].pop("north_star")
    # The JAX recipe also runs its mu-law wire lever, which the port has not.
    for report in outs["jax"]:
        report["levers"].pop("wire8")
    assert outs["port"] == outs["jax"]
