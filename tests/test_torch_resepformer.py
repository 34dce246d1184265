"""The published RE-SepFormer layout (models/resepformer.Resepformer,
``TorchConfig.separator = "resepformer-wsj02mix"``) on the CPU: a padded
batch with lengths equals the plain float32 reference
(benchmark/ccbench/resepformer_reference.py, which imports nothing of the
port or of JAX) run on each row alone; the published widths' parameter
count; the engine's overlap path hands the separator its lengths; the
spans and counters; and the native checkpoint round trip.

One torch thread, TF32 off. The tolerance, 1e-5 of a source's largest
sample, is float32 rounding: both sides run the same operations in IEEE
float32 in another association (batched products, masked sums), which
leaves a few 1e-7; a wrong mask or a padded frame seen moves a source by
1e-2 or more (``test_without_lengths_the_padding_shows``).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from clearconverse_tpu_torch.models import resepformer as rsf
from clearconverse_tpu_torch.utils.tracing import StageTimer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = rsf.ResepformerDims(enc_channels=16, n_heads=2, d_ffn=32,
                           segment_size=6, n_layers=2)
TOL = 1e-5


def _reference():
    path = os.path.join(ROOT, "benchmark", "ccbench",
                        "resepformer_reference.py")
    spec = importlib.util.spec_from_file_location("resepformer_reference",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def recipe(d: rsf.ResepformerDims) -> dict:
    """The dims under the recipe's names, as the reference reads them."""
    return {"N_encoder_out": d.enc_channels, "out_channels": d.d_model,
            "kernel_size": d.enc_kernel, "kernel_stride": d.enc_stride,
            "num_spks": d.n_sources, "segment_size": d.segment_size,
            "layer": d.n_blocks, "num_layers": d.n_layers,
            "nhead": d.n_heads, "d_ffn": d.d_ffn}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = mm
    torch.set_num_threads(n)


def _batch():
    """Three rows of different lengths and one of length 0, padded to 1000
    samples (lengths that leave a frame straddling the end, fill a
    segment exactly, and span several segments)."""
    lens = torch.tensor([1000, 16 + 8 * 47, 377, 0])
    g = torch.Generator().manual_seed(5)
    mix = torch.randn(4, 1000, generator=g) * 0.3
    for i, n in enumerate(lens.tolist()):
        mix[i, n:] = 0.0
    return mix, lens


def _row_gaps(out, mix, lens, model):
    w = dict(model.named_parameters())
    gaps = []
    for i, n in enumerate(lens.tolist()):
        if n < model.dims.enc_kernel:
            assert torch.count_nonzero(out[i]) == 0
            continue
        want = REF.separate_one(w, recipe(model.dims), mix[i, :n])
        gaps.append(float((out[i, :n] - want).abs().max()
                          / want.abs().max()))
    return gaps


def test_a_padded_batch_equals_each_row_alone():
    model = rsf.init_resepformer(TINY, seed=3, device="cpu")
    mix, lens = _batch()
    out = rsf.sepformer_separate(model, mix, lens)
    assert out.shape == (4, 1000, 2) and torch.isfinite(out).all()
    gaps = _row_gaps(out, mix, lens, model)
    assert len(gaps) == 3 and max(gaps) < TOL, gaps
    # Past its length a row is zero, as the engine keeps only its samples.
    for i, n in enumerate(lens.tolist()):
        assert torch.count_nonzero(out[i, n:]) == 0


def test_without_lengths_the_padding_shows():
    model = rsf.init_resepformer(TINY, seed=3, device="cpu")
    mix, lens = _batch()
    out = rsf.sepformer_separate(model, mix)
    gaps = _row_gaps(out[:3], mix[:3], lens[:3], model)
    assert gaps[0] < TOL                 # the full-length row has no padding
    assert min(gaps[1:]) > 100 * TOL, gaps


def test_published_widths_build_the_published_parameter_count():
    with torch.device("meta"):
        model = rsf.Resepformer(rsf.ResepformerDims())
    n = sum(p.numel() for p in model.parameters())
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "resepformer-wsj02mix.json")) as fh:
        cfg = json.load(fh)["resepformer"]
    assert n == 7955201 == cfg["parameters"] == REF.parameter_count(cfg)
    assert rsf.SEPARATORS["resepformer-wsj02mix"] == rsf.ResepformerDims()
    assert {k: cfg[k] for k in recipe(TINY)} == recipe(rsf.ResepformerDims())


def test_spans_counters_and_ranges():
    model = rsf.init_resepformer(TINY, seed=1, device="cpu")
    mix, lens = _batch()
    timer = StageTimer(sync=True)
    rsf.sepformer_separate(model, mix, lens, timer)
    assert set(timer.as_dict()) == {"sep.encoder", "sep.seg_block",
                                    "sep.mem_block", "sep.decoder"}
    assert [n for n, _ in timer.spans].count("sep.seg_block") == 2
    # Segments run: each row's frames // K + 1, a row without frames one.
    assert rsf.resepformer_segments(lens.numpy(), TINY) == \
        (124 // 6 + 1) + (48 // 6 + 1) + (46 // 6 + 1) + 1
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rsf.sepformer_separate(model, mix, lens)
    names = {e.name for e in prof.events() if e.name.startswith("cc:")}
    assert names == {"cc:sep.encoder", "cc:sep.seg_block", "cc:sep.mem_block",
                     "cc:sep.decoder"}


def _bundle(separator="resepformer-wsj02mix"):
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.ecapa import EcapaDims, init_ecapa
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.models.whisper import WhisperDims
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        craft_pyannet_freq_params)
    dims = WhisperDims(n_audio_state=64, n_audio_head=2, n_audio_layer=1,
                       n_text_state=64, n_text_head=2, n_text_layer=1)
    tc = TorchConfig(max_decode_tokens=4, best_of=2, separator=separator,
                     diarization_onset=0.35, diarization_offset=0.25,
                     diarization_cluster_threshold=0.30)
    b = ModelBundle(config=Config(min_speakers=2), torch_config=tc,
                    device="cpu")
    b._whisper = (init_whisper(dims, 0, "cpu"), dims, ByteFallbackTokenizer())
    edims = EcapaDims(n_mels=24, channels=32, mfa_channels=48,
                      attention_channels=16, embedding_dim=16,
                      res2net_scale=4)
    b._ecapa, b._ecapa_dims = init_ecapa(edims, 1, "cpu"), edims
    b._pyannet, b._pyannet_dims = craft_pyannet_freq_params(device="cpu")
    b._sepformer = rsf.init_resepformer(TINY, seed=2, device="cpu")
    b._loaded = True
    return b


def test_the_bundle_builds_the_configured_separator():
    b = _bundle()
    assert isinstance(b._load_sepformer(), rsf.Resepformer)
    assert b._load_sepformer().dims == rsf.ResepformerDims()
    assert isinstance(_bundle("sketch")._load_sepformer(), rsf.Sepformer)
    with pytest.raises(ValueError, match="unknown separator"):
        _bundle("sepformer-large")._load_sepformer()


def test_separate_batch_pads_rows_and_lengths():
    b = _bundle()
    mix, lens = _batch()
    out = b.separate_batch(mix[:3].numpy(), lens[:3].numpy())
    assert out.shape == (3, 1000, 2)
    assert b.last_separation == {
        "rows": 4, "samples": 4000,
        "segments": rsf.resepformer_segments(lens.numpy(), TINY)}
    np.testing.assert_array_equal(
        out, rsf.sepformer_separate(b._sepformer, mix[:3], lens[:3]).numpy())


def test_process_files_separates_the_overlap_with_lengths(tmp_path):
    from clearconverse_tpu_torch.audio.wav import write_wav
    from clearconverse_tpu_torch.pipeline.dev_backend import synth_conversation
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine
    b = _bundle()
    path = str(tmp_path / "conv.wav")
    write_wav(path, synth_conversation(), 16000)
    calls = []
    orig = b.separate_batch

    def recording(audio, lengths=None):
        calls.append((np.asarray(audio).shape, lengths))
        return orig(audio, lengths)

    b.separate_batch = recording
    eng = TranscriptionEngine(config=b.config, torch_config=b.torch_config,
                              models=b)
    res = eng.process_files([path])
    assert res[0] is not None
    assert any(s.is_overlap for s in res[0]["segments"])
    assert calls and all(lens is not None and len(lens) == shape[0]
                         for shape, lens in calls)
    c = eng.last_run_separation
    assert c["calls"] == len(calls)
    assert c["real_rows"] == sum(shape[0] for shape, _ in calls)
    assert c["real_samples"] == sum(int(np.sum(lens)) for _, lens in calls)
    assert c["rows"] >= c["real_rows"] and c["samples"] > c["real_samples"]
    assert c["segments"] > 0


@pytest.mark.parametrize("with_meta", [True, False], ids=["meta", "pre_meta"])
def test_save_native_round_trips_the_published_layout(tmp_path, with_meta):
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    src = _bundle()
    path = str(tmp_path / "bundle.pt")
    src.save_native(path)
    if not with_meta:
        payload = torch.load(path, weights_only=True)
        assert payload["meta"]["sepformer_dims"]["layout"] == "resepformer"
        del payload["meta"]
        torch.save(payload, path)
    dst = ModelBundle(torch_config=src.torch_config, device="cpu")
    dst.load_native(path)
    sep = dst._sepformer
    assert isinstance(sep, rsf.Resepformer)
    if with_meta:
        assert sep.dims == TINY
    else:
        # No weight holds the head count or the segment size.
        assert sep.dims == rsf.ResepformerDims(enc_channels=16, d_ffn=32,
                                               n_layers=2)
    a, b = src._sepformer.state_dict(), sep.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_state_dicts_and_dims_round_trip():
    model = rsf.init_resepformer(TINY, seed=4, device="cpu")
    sds = [getattr(model, p).state_dict()
           for p in ("encoder", "masknet", "decoder")]
    tree = rsf.convert_speechbrain_sepformer(*sds)
    assert rsf.infer_sepformer_dims(tree, TINY) == TINY
    assert rsf.dims_from_meta(rsf.dims_to_meta(TINY)) == TINY
    assert rsf.dims_from_meta(rsf.dims_to_meta(rsf.SepformerDims())) == \
        rsf.SepformerDims()
    for got, sd in zip(rsf.sepformer_to_state_dicts(tree), sds):
        assert got.keys() == sd.keys()
        assert all(np.array_equal(got[k], sd[k].numpy()) for k in sd)
    back = rsf.sepformer_from_jax_params(tree, TINY, "cpu")
    mix, lens = _batch()
    assert torch.equal(rsf.sepformer_separate(back, mix, lens),
                       rsf.sepformer_separate(model, mix, lens))
