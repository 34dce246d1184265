"""The port's TranscriptionEngine end to end on the CPU: the recorded
DevModels transcript byte for byte, identical transcripts to the JAX engine
(on DevModels, and on the same converted tiny weights with a >30 s segment
through transcribe_long_batch, and with an overlap through RE-SepFormer
separation), and the per-file isolation that never swallows a missing piece
or a CUDA error."""

import dataclasses
import logging
import pathlib

import numpy as np
import pytest

import torch

from clearconverse_tpu.config import Config as JConfig, TPUConfig
from clearconverse_tpu.pipeline.dev_backend import DevModels as JDevModels
from clearconverse_tpu.pipeline.engine import TranscriptionEngine as JEngine

from clearconverse_tpu_torch.audio.wav import write_wav
from clearconverse_tpu_torch.config import Config, TorchConfig
from clearconverse_tpu_torch.pipeline.cancel import ProcessingCancelled
from clearconverse_tpu_torch.pipeline.dev_backend import (
    HIGH, LOW, SR, DevModels, synth_conversation, synth_conversation_speech)
from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine
from clearconverse_tpu_torch.utils.errors import is_fatal

# The suite runs several pytest workers on one host; with torch's default of
# one intra-op thread per core they oversubscribe it, and these small ops
# then run ~100x slower than alone. One thread each keeps them fast.
torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "devmodels_transcript.txt"


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _wav(tmp_path, name, audio):
    p = str(tmp_path / name)
    write_wav(p, audio, SR)
    return p


def _dev_engine(**cfg):
    return TranscriptionEngine(Config(**cfg), TorchConfig(),
                               models=DevModels(), device="cpu")


def test_devmodels_pipeline_matches_recorded_transcript(tmp_path):
    eng = _dev_engine(noise_reduction_amount=0.0, temperature=0.0)
    wav = _wav(tmp_path, "conv.wav", synth_conversation())
    _, transcript, path = eng.run(wav, str(tmp_path))
    recorded = FIXTURE.read_text()
    assert transcript == recorded
    assert open(path).read() == recorded


def _segments(res):
    return [(round(s.start, 6), round(s.end, 6), s.speaker_id, s.is_overlap,
             s.transcription) for s in res["segments"]]


def _confidences(res):
    return np.array([s.confidence for s in res["segments"]], np.float64)


def test_devmodels_process_files_matches_jax_engine(tmp_path):
    """Two files through both engines' process_files on DevModels (denoise
    on, so the gate and wire run): identical segments, labels and texts."""
    paths = [_wav(tmp_path, "a.wav", synth_conversation()),
             _wav(tmp_path, "b.wav", synth_conversation_speech(seed=3))]
    ours = _dev_engine(temperature=0.0).process_files(paths)
    ref = JEngine(JConfig(temperature=0.0), TPUConfig(),
                  models=JDevModels()).process_files(paths)
    assert [_segments(r) for r in ours] == [_segments(r) for r in ref]
    assert all(r["segments"] for r in ours)
    # Overlap confidences are cosines of embeddings of gated audio; the
    # pure-tone file's gate sits near its threshold in a few bins, so they
    # agree to 1e-2, not bit for bit.
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(_confidences(a), _confidences(b),
                                   atol=1e-2)


def test_run_many_and_stage_split(tmp_path):
    eng = _dev_engine()
    paths = [_wav(tmp_path, f"f{i}.wav", synth_conversation()) for i in range(2)]
    outs = eng.run_many([(p, str(tmp_path / f"out{i}"))
                         for i, p in enumerate(paths)])
    assert all(o[1] and o[2] for o in outs)
    st = eng.last_run_stage_times
    for key in ("load_gate", "segmentation", "diarize_cluster", "profiles",
                "segment_embeds", "decode_wavefront"):
        assert key in st, st
    assert eng.last_run_wire["format"] == "int16"     # pure tones: no pack


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TranscriptionEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TranscriptionEngine(models=DevModels())


def test_is_fatal():
    assert is_fatal(NotImplementedError("x"))
    assert is_fatal(RuntimeError("CUDA error: an illegal memory access"))
    assert not is_fatal(RuntimeError("shape mismatch"))
    assert not is_fatal(ValueError("No speakers detected in the audio file"))


class _Failing(DevModels):
    def __init__(self, exc):
        super().__init__()
        self.exc = exc

    def segment_frames(self, audio):
        raise self.exc


@pytest.mark.parametrize("exc", [RuntimeError("CUDA error: launch failure"),
                                 NotImplementedError("not ported")])
def test_fatal_errors_propagate_out_of_process_files(tmp_path, exc, caplog):
    eng = TranscriptionEngine(Config(), TorchConfig(), models=_Failing(exc),
                              device="cpu")
    wav = _wav(tmp_path, "c.wav", synth_conversation())
    with caplog.at_level(logging.ERROR, logger="clearconverse_tpu_torch"):
        with pytest.raises(type(exc)):
            eng.process_files([wav])
    assert not caplog.records


def test_ordinary_errors_stay_per_file(tmp_path, caplog):
    """A non-fatal failure keeps the JAX package's isolation: logged, and
    the file comes back None."""
    eng = TranscriptionEngine(Config(), TorchConfig(),
                              models=_Failing(ValueError("bad window")),
                              device="cpu")
    wav = _wav(tmp_path, "c.wav", synth_conversation())
    with caplog.at_level(logging.ERROR, logger="clearconverse_tpu_torch"):
        assert eng.process_files([wav]) == [None]
    assert any("bad window" in r.getMessage() for r in caplog.records)


def test_cancel_before_and_between_batches(tmp_path):
    """Cancel before the run pays no work; cancel after the first decode
    batch (batch size 1: one segment a batch) stops the wavefront there."""
    eng = TranscriptionEngine(Config(transcription_batch_size=1),
                              TorchConfig(), models=DevModels(), device="cpu")
    wav = _wav(tmp_path, "c.wav", synth_conversation())
    with pytest.raises(ProcessingCancelled):
        eng.process_files([wav], should_cancel=lambda: True)
    assert eng.models.transcribe_calls == []
    with pytest.raises(ProcessingCancelled):
        eng.process_files([wav], should_cancel=lambda: bool(
            eng.models.transcribe_calls))
    assert len(eng.models.transcribe_calls) == 1


# ----------------------------------------------- the real bundle, tiny dims

def _tiny_pair(knobs):
    """A JAX bundle and a port bundle holding the same weights: tiny
    Whisper, ECAPA and RE-SepFormer (the JAX package's random init),
    crafted PyanNet."""
    import jax
    from clearconverse_tpu.models import ecapa as jecapa
    from clearconverse_tpu.pipeline.dev_backend import (
        craft_pyannet_freq_params as j_craft)
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        craft_pyannet_freq_params)
    from test_multichip_serving import _tiny_bundle
    from test_speaker_golden import DIMS as EDIMS
    from test_torch_speaker import port_bundle_like

    jb = _tiny_bundle(TPUConfig(**knobs))
    jb._ecapa = jecapa.init_ecapa_params(jax.random.PRNGKey(38), EDIMS)
    jb._ecapa_dims = EDIMS
    jb._pyannet, jb._pyannet_dims = j_craft()
    from clearconverse_tpu_torch.models import resepformer as rsf
    tb = port_bundle_like(jb, knobs)
    tb._pyannet, _ = craft_pyannet_freq_params(device="cpu")
    tb._sepformer = rsf.sepformer_from_jax_params(
        jax.tree.map(np.asarray, jb._sepformer),
        rsf.SepformerDims(**dataclasses.asdict(jb._sepformer_dims)), "cpu")
    return jb, tb


KNOBS = dict(max_decode_tokens=8, compute_dtype="float32", cross_kv_bits=16,
             diarization_onset=0.35, diarization_offset=0.25,
             diarization_cluster_threshold=0.30)


def _monologue():
    """45 s: the low speaker for 36 s, the high one for 5 s, low again."""
    t = np.arange(45 * SR) / SR
    low = 0.5 * np.sin(2 * np.pi * LOW * t)
    high = 0.5 * np.sin(2 * np.pi * HIGH * t)
    g = lambda a, b: ((t >= a) & (t < b)).astype(np.float32)  # noqa: E731
    return (low * (g(0, 36) + g(42, 45)) + high * g(37, 41.5)).astype(np.float32)


def test_tiny_weights_engine_matches_jax_with_long_segment(tmp_path):
    """Port and JAX engines on the same converted tiny weights, f32, t=0:
    identical transcripts, including a >30 s segment that both decode
    through transcribe_long_batch."""
    jb, tb = _tiny_pair(KNOBS)
    cfg = dict(temperature=0.0)
    wav = _wav(tmp_path, "long.wav", _monologue())
    calls = {"port": 0, "jax": 0}

    def counting(b, key):
        orig = b.transcribe_long_batch

        def wrapped(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        b.transcribe_long_batch = wrapped

    counting(tb, "port")
    counting(jb, "jax")
    tc = TorchConfig(**KNOBS)
    ours = TranscriptionEngine(Config(**cfg), tc, models=tb).process_files([wav])
    ref = JEngine(JConfig(**cfg), jb.tpu, models=jb).process_files([wav])
    assert ours[0] is not None and ref[0] is not None
    assert _segments(ours[0]) == _segments(ref[0])
    assert calls["port"] == calls["jax"] >= 1
    assert max(s.end - s.start for s in ours[0]["segments"]) > 30.0


def test_overlap_engine_matches_jax_and_logs_nothing(tmp_path, caplog):
    """The crafted PyanNet finds the synthetic conversation's overlap: port
    and JAX engines on the same converted tiny weights (RE-SepFormer
    included), f32, t=0, separate it and give identical segments, overlap
    flags, speakers and texts; the port logs no ERROR."""
    jb, tb = _tiny_pair(KNOBS)
    wav = _wav(tmp_path, "conv.wav", synth_conversation())
    calls = {"port": 0, "jax": 0}

    def counting(b, key):
        orig = b.separate_batch

        def wrapped(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        b.separate_batch = wrapped

    counting(tb, "port")
    counting(jb, "jax")
    cfg = dict(temperature=0.0)
    eng = TranscriptionEngine(Config(**cfg), TorchConfig(**KNOBS), models=tb)
    with caplog.at_level(logging.ERROR, logger="clearconverse_tpu_torch"):
        ours = eng.process_files([wav])
    assert not caplog.records
    ref = JEngine(JConfig(**cfg), jb.tpu, models=jb).process_files([wav])
    assert ours[0] is not None and ref[0] is not None
    assert _segments(ours[0]) == _segments(ref[0])
    assert any(s.is_overlap for s in ours[0]["segments"])
    assert calls["port"] == calls["jax"] >= 1
    assert "prepare_files.separate_dev" in eng.last_run_stage_times


def test_store_path_equals_host_path(tmp_path):
    """The same port bundle with the device store on and off: identical
    segments and texts."""
    _, tb = _tiny_pair(KNOBS)
    wav = _wav(tmp_path, "s.wav", synth_conversation()[: 9 * SR])
    eng = TranscriptionEngine(Config(temperature=0.0), TorchConfig(**KNOBS),
                              models=tb)
    with_store = eng.process_files([wav])
    tb.supports_store = False
    try:
        without = eng.process_files([wav])
    finally:
        del tb.supports_store
    assert _segments(with_store[0]) == _segments(without[0])
    assert with_store[0]["segments"]
    assert dataclasses.is_dataclass(with_store[0]["segments"][0])
    assert isinstance(with_store[0]["segments"][0].audio, np.ndarray)
