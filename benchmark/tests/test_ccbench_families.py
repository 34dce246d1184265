"""The check as a list of model families that a configuration names
(``families/<name>.py``): a family added as a file is recorded and
checked with no file of the benchmark edited, and its own fault turns
``correct`` false; a limit that no family reads leaves the cell not
correct; widths that differ from the program's are refused at set-up; and
the ``whisper`` and ``speakers`` families keep the same calls and read the
same numbers as their reading functions called directly on recorders
wired by hand."""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os

import pytest
import torch

from helpers import TINY, TINY_LIMITS, tiny_copy

import run  # after helpers, which puts the benchmark on sys.path
from ccbench import weights
from ccbench.check import Check, check_rng
from ccbench.engine_cell import EngineCell
from ccbench.spec import Cell

SEED = 2**31 + 45


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _result(root, workload, fault=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(SEED),
                       "--seconds", "1", "--trace", "0"],
                      device="cpu", need_card=False, fault=fault,
                      bench_dir=f"{root}/benchmark", root=root)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _json(path, obj=None):
    if obj is None:
        with open(path) as fh:
            return json.load(fh)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)


# A family of its own: K1's mel power (``ops.logmel.mel_power``, which the
# encoder's log-mel calls by its module's name) against torch.stft and a
# slaney filterbank in float64. It draws no weights.
MEL_FAMILY = '''
import numpy as np
import torch

from ccbench.record import Keeper, Patch

STREAM = 9


def dims(config):
    return dict(config["melpower"])


def program_dims(engine):
    return {"n_mels": engine.models._whisper[1].n_mels}


def draw(dims, seed, device):
    return {}


def fill(engine, weights):
    assert weights == {}


class Recorder:
    def __init__(self, rng, sample):
        from clearconverse_tpu_torch.ops import logmel
        self.active, self.fault = False, None
        self.keep = Keeper(rng, sample)

        def make(orig):
            def wrapped(audio, n_mels=80):
                out = orig(audio, n_mels)
                if self.fault is not None:
                    out = self.fault(out)
                if self.active:
                    self.keep.offer({"audio": audio, "n_mels": n_mels,
                                     "out": out}, audio.shape[0])
                return out
            return wrapped

        self._patch = Patch(logmel, "mel_power", make)

    def kept(self):
        return self.keep.kept()

    def remove(self):
        self._patch.remove()


def recorder(rng, sample):
    return Recorder(rng, sample)


def _filterbank(n_mels, sr=16000, n_fft=400):
    step = np.log(6.4) / 27.0

    def to_mel(f):
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                        / step, f * 3.0 / 200.0)

    def to_hz(m):
        return np.where(m >= 15.0, 1000.0 * np.exp(step * (m - 15.0)),
                        m * 200.0 / 3.0)

    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    pts = to_hz(np.linspace(to_mel(0.0), to_mel(sr / 2.0), n_mels + 2))
    lower = (freqs[None] - pts[:-2, None]) / (pts[1:-1] - pts[:-2])[:, None]
    upper = (pts[2:, None] - freqs[None]) / (pts[2:] - pts[1:-1])[:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    return torch.from_numpy(fb * (2.0 / (pts[2:] - pts[:-2]))[:, None])


def reference(audio, n_mels):
    x = audio.double()
    window = torch.hann_window(400, dtype=torch.float64, device=x.device)
    spec = torch.stft(x, 400, 160, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec.abs()[..., :-1] ** 2
    return torch.einsum("bkf,mk->bfm", power, _filterbank(n_mels).to(x.device))


def readings(recorder, dims, seed, device, control):
    gap, low_gap, rows = 0.0, 0.0, 0
    for rec in recorder.kept():
        ref = reference(rec["audio"], rec["n_mels"])
        scale = float(ref.abs().max())
        gap = max(gap, float((rec["out"].double() - ref).abs().max()) / scale)
        if control:
            low = reference(rec["audio"].half(), rec["n_mels"])
            low_gap = max(low_gap, float((low - ref).abs().max()) / scale)
        rows += rec["audio"].shape[0]
    if not rows:
        return {"numbers": {}, "control": {}, "counts": {"mel_rows": 0}}
    return {"numbers": {"mel_power_gap": gap},
            "control": {"mel_power_gap": low_gap} if control else {},
            "counts": {"mel_rows": rows}}


def altered_mel(out):
    out = out.clone()
    out[0, 0, 0] = 2 * out.max() + 1
    return out


FAULTS = {"altered_mel": ("mel_power", altered_mel)}
'''

MEL_LIMITS = {**TINY_LIMITS, "mel_power_gap": 1e-4}


def _files(folder):
    out = {}
    for d, _, files in os.walk(folder):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.join(d, f)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _add_mel_cell(root):
    """The family, a configuration that names it and a cell of that
    configuration, as new files and new entries only."""
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "families", "melpower.py"), "w") as fh:
        fh.write(MEL_FAMILY)
    cfg = _json(os.path.join(b, "configs", "whisper-tiny.en.json"))
    cfg.update(name="whisper-tiny.en-mel", melpower={"n_mels": 80},
               families=cfg["families"] + ["melpower"])
    _json(os.path.join(b, "configs", "whisper-tiny.en-mel.json"), cfg)
    _json(os.path.join(b, "limits", "tiny-mel.json"), MEL_LIMITS)
    manifest = _json(os.path.join(root, "BENCHMARK.json"))
    manifest["configs"].append({
        "name": "whisper-tiny.en-mel", "source": "test",
        "file": "benchmark/configs/whisper-tiny.en-mel.json", "reduced": [],
        "why": "CPU tests"})
    manifest["workloads"].append({
        "name": "tiny-mel", "config": "whisper-tiny.en-mel",
        "traffic": "files_1_tiny", "chips": 1, "why": "CPU tests"})
    _json(os.path.join(root, "BENCHMARK.json"), manifest)


@pytest.mark.parametrize("fault", [None, "altered_mel"])
def test_a_family_added_as_a_file_is_checked_with_no_edit(tmp_path, fault):
    root = tiny_copy(str(tmp_path))
    b = os.path.join(root, "benchmark")
    before = _files(b)
    _add_mel_cell(root)
    res = _result(root, "tiny-mel", fault)
    after = _files(b)
    assert {p: h for p, h in after.items() if p in before} == before
    assert {k: c["limit"] for k, c in res["checks"].items()} == MEL_LIMITS
    mel = res["checks"]["mel_power_gap"]
    assert mel["value"] is not None
    assert res["correct"] is (fault is None)
    if fault is None:
        assert mel["value"] < mel["limit"]
    else:
        assert mel["value"] > mel["limit"]


def test_a_limit_that_no_family_reads_is_not_correct(tmp_path):
    limits = {**TINY_LIMITS, "nothing_reads_this": 1.0}
    res = _result(tiny_copy(str(tmp_path), limits=limits), TINY)
    assert res["correct"] is False
    assert res["checks"]["nothing_reads_this"]["value"] is None
    assert all(c["value"] <= c["limit"] for k, c in res["checks"].items()
               if k != "nothing_reads_this")


@pytest.mark.parametrize("family,change", [
    ("whisper", {"d_model": 512}),
    ("speakers", {"ecapa": {"channels": 256}}),
])
def test_widths_that_differ_from_the_programs_are_refused(tmp_path, family,
                                                          change):
    root = tiny_copy(str(tmp_path))
    cell = Cell(TINY, f"{root}/benchmark", root)
    cfg = json.loads(json.dumps(cell.config))
    for key, value in change.items():
        if isinstance(value, dict):
            cfg[key].update(value)
        else:
            cfg[key] = value
    with pytest.raises(RuntimeError, match=f"family '{family}' are not the "
                                           "configuration's"):
        EngineCell(cfg, cell.families(), torch.device("cpu"),
                   str(tmp_path / "engine"))


def test_the_families_keep_and_read_what_the_reading_functions_do(tmp_path):
    # The families' recorders and a pair wired by hand as the check was
    # before families (the decode calls on stream 7, both speaker models
    # on one generator of stream 8) wrap the same calls of one window.
    root = tiny_copy(str(tmp_path))
    cell = Cell(TINY, f"{root}/benchmark", root)
    families = cell.families()
    whisper, speakers = families["whisper"], families["speakers"]
    kind, mix = cell.kind(), cell.traffic
    dev = torch.device("cpu")
    n = mix["check_calls"] - 1
    ec = EngineCell(cell.config, families, dev, str(tmp_path / "engine"))
    chk = Check(families, SEED, n)
    dec = whisper.DecodeRecorder(check_rng(SEED, 7), n)
    spk = speakers.SpeakerRecorder(check_rng(SEED, 8), n)
    try:
        ec.load_seed(SEED)
        inputs = kind.generate(mix, SEED, ec.inputs_dir(SEED))
        kind.warm(ec, mix, inputs)
        chk.set_active(True)
        dec.active = spk.active = True
        kind.window(ec, mix, inputs, 1.0)
        chk.set_active(False)
        dec.active = spk.active = False
    finally:
        spk.remove()
        dec.remove()
        chk.remove()
    fam_dec, fam_spk = chk.recorders["whisper"], chk.recorders["speakers"]
    assert len(fam_dec.kept()) == len(dec.kept()) >= 1
    assert all(a["packed"] is b["packed"]
               for a, b in zip(fam_dec.kept(), dec.kept()))
    for model in ("pyannet", "ecapa"):
        got, want = fam_spk.kept(model), spk.kept(model)
        assert len(got) == len(want) >= 1
        assert all(a["out"] is b["out"] for a, b in zip(got, want))
    fields = chk.run_fields(ec.dims)
    assert fields["dims"] == whisper.dims(cell.config)
    assert len(fields["decode_calls"]) == len(dec.rows_and_steps())
    ec.close()
    got = chk.readings(ec.dims, SEED, dev)
    wd, sd = ec.dims["whisper"], ec.dims["speakers"]
    w = whisper.whisper_readings(
        dec.kept(), wd,
        weights.reference_weights(weights.whisper_spec(wd), SEED, dev))
    s = speakers.speaker_readings(spk.kept("pyannet"), spk.kept("ecapa"), sd,
                                  weights.speaker_weights(sd, SEED, dev))
    assert got["numbers"] == {**w["numbers"], **s["numbers"]}
    assert set(got["numbers"]) == {"logprob_gap", "logprob_gap_mean",
                                   "seg_logprob_gap", "embed_gap"}
    assert got["counts"] == {"rows": w["rows"], "tokens": w["tokens"],
                             "seg_rows": s["seg_rows"],
                             "embed_rows": s["embed_rows"]}
