"""The port's speaker half against the JAX package's on the same weights and
inputs, TF32 pinned off: speechbrain fbank, ECAPA and PyanNet through the
JAX-pytree bridges and through both state-dict converters, every bundle
speaker method (host and store variants, and against the JAX bundle),
file activities, diarization with the crafted PyanNet weights, and the
>30 s seek decode (transcribe_long_batch). Tolerances are the reference
tests' (tests/test_speaker_models.py, tests/test_store.py)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from clearconverse_tpu.config import Config as JConfig, TPUConfig
from clearconverse_tpu.models import ecapa as jecapa
from clearconverse_tpu.models import pyannet as jpyannet

from clearconverse_tpu_torch.config import TorchConfig
from clearconverse_tpu_torch.models import ecapa as tecapa
from clearconverse_tpu_torch.models import pyannet as tpyannet
from clearconverse_tpu_torch.models.convert import whisper_from_jax_params
from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
from clearconverse_tpu_torch.models.whisper import WhisperDims
from clearconverse_tpu_torch.pipeline.bundle import ModelBundle

from test_multichip_serving import _tiny_bundle
from test_speaker_golden import DIMS as GOLD_ECAPA
from test_speaker_golden import PN as GOLD_PYANNET
from test_speaker_golden import _make_ecapa_sd, _make_pyannet_sd

# The suite runs several pytest workers on one host; with torch's default of
# one intra-op thread per core they oversubscribe it, and these small ops
# then run ~100x slower than alone. One thread each keeps them fast.
torch.set_num_threads(1)

SR = 16000
KNOBS = dict(max_decode_tokens=8, compute_dtype="float32", cross_kv_bits=16)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_bundle_like(jb, knobs=KNOBS, device="cpu") -> ModelBundle:
    """A port ModelBundle holding the JAX bundle ``jb``'s weights (Whisper,
    ECAPA, PyanNet through the bridges), byte-fallback tokenizer."""
    params, jdims, _ = jb._whisper
    wdims = WhisperDims(**dataclasses.asdict(jdims))
    tb = ModelBundle(torch_config=TorchConfig(**knobs), device=device)
    tb._whisper = (whisper_from_jax_params(_np_tree(params), wdims, device),
                   wdims, ByteFallbackTokenizer(english=True))
    tb._ecapa = tecapa.ecapa_from_jax_params(_np_tree(jb._ecapa), device)
    tb._ecapa_dims = tecapa.EcapaDims(**dataclasses.asdict(jb._ecapa_dims))
    tb._pyannet_dims = tpyannet.PyannetDims(
        **dataclasses.asdict(jb._pyannet_dims))
    tb._pyannet = tpyannet.pyannet_from_jax_params(
        _np_tree(jb._pyannet), tb._pyannet_dims, device)
    tb._loaded = True
    return tb


@pytest.fixture(scope="module")
def bundles():
    jb = _tiny_bundle(TPUConfig(**KNOBS))
    # Rows of the token table above the byte ids shrink (EOT's kept), so
    # the byte-fallback tokenizer renders text from random weights.
    tok = np.array(jb._whisper[0]["decoder"]["tok"])
    tok[256:50256] *= 0.01
    jb._whisper[0]["decoder"]["tok"] = jnp.asarray(tok)
    return jb, port_bundle_like(jb)


def _clips(seed, n, t, scale=0.1):
    return (np.random.default_rng(seed).standard_normal((n, t))
            .astype(np.float32) * scale)


# ---------------------------------------------------------------- models

def test_fbank_matches_jax():
    x = _clips(0, 3, 9000)
    mask = np.ones((3, 1 + 9000 // 160), np.float32)
    mask[1, 30:] = 0.0
    for m in (None, mask):
        ours = tecapa.fbank(torch.from_numpy(x), 24,
                            None if m is None else torch.from_numpy(m))
        ref = jecapa.fbank(jnp.asarray(x), 24,
                           None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def test_ecapa_bridge_matches_jax(bundles):
    jb, tb = bundles
    x = _clips(1, 3, 12000)
    lens = np.array([12000, 7000, 3000])
    x[1, 7000:] = 0.0
    x[2, 3000:] = 0.0
    ours = tecapa.ecapa_embed(tb._ecapa, torch.from_numpy(x),
                              torch.from_numpy(lens), tb._ecapa_dims)
    ref = jecapa.ecapa_embed(jb._ecapa, jnp.asarray(x), jnp.asarray(lens),
                             jb._ecapa_dims)
    assert ours.shape == (3, tb._ecapa_dims.embedding_dim)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def test_ecapa_state_dict_converter_matches_jax():
    """speechbrain-keyed weights (the golden test's) through both
    converters give the same pytree and the same embeddings."""
    sd = _make_ecapa_sd(np.random.default_rng(5))
    tree_t = tecapa.convert_speechbrain_ecapa(sd)
    tree_j = jecapa.convert_speechbrain_ecapa(
        {k: v.numpy() for k, v in sd.items()})
    for a, b in zip(jax.tree.leaves(tree_t), jax.tree.leaves(tree_j)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    dims = tecapa.infer_ecapa_dims(tree_t)
    assert dataclasses.asdict(dims) == dataclasses.asdict(GOLD_ECAPA)
    x = _clips(2, 2, 16000)
    ours = tecapa.ecapa_embed(tecapa.ecapa_from_jax_params(tree_t, "cpu"),
                              torch.from_numpy(x), None, dims)
    ref = jecapa.ecapa_embed(jax.tree.map(jnp.asarray, tree_j),
                             jnp.asarray(x), None, GOLD_ECAPA)
    # These weights give embeddings of size ~1e4, so the golden ECAPA
    # test's relative tolerance applies (tests/test_speaker_golden.py).
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-3,
                               atol=2e-4)


def test_sinc_filters_match_jax():
    low = np.linspace(40, 3000, 4).astype(np.float32)
    band = np.linspace(60, 400, 4).astype(np.float32)
    ours = tpyannet.sinc_filters(torch.from_numpy(low),
                                 torch.from_numpy(band), 251, SR)
    ref = np.asarray(jpyannet.sinc_filters(jnp.asarray(low),
                                           jnp.asarray(band), 251, SR))
    np.testing.assert_allclose(ours.numpy()[:, 0, :].T, ref[:, 0, :],
                               atol=1e-6)


def test_pyannet_bridge_matches_jax_on_padded_windows(bundles):
    """pyannet_forward + powerset_to_multilabel through the bridge, on
    windows whose tails are zero padding (the BiLSTM's backward direction
    starts in the padding)."""
    jb, tb = bundles
    x = _clips(3, 3, 2 * SR)
    x[1, SR:] = 0.0
    x[2, 5000:] = 0.0
    ours = tpyannet.pyannet_forward(tb._pyannet, torch.from_numpy(x),
                                    tb._pyannet_dims)
    ref = jpyannet.pyannet_forward(jb._pyannet, jnp.asarray(x),
                                   jb._pyannet_dims)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(
        tpyannet.powerset_to_multilabel(ours).numpy(),
        np.asarray(jpyannet.powerset_to_multilabel(ref)), atol=1e-5)


def test_pyannet_state_dict_converter_matches_jax():
    """pyannote-keyed weights with a torch nn.LSTM (the golden test's)
    through both converters: the same pytree, the same scores."""
    sd, _ = _make_pyannet_sd(np.random.default_rng(4))
    tree_t = tpyannet.convert_pyannote_pyannet(sd)
    tree_j = jpyannet.convert_pyannote_pyannet(sd, GOLD_PYANNET)
    for a, b in zip(jax.tree.leaves(tree_t), jax.tree.leaves(tree_j)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # The sinc kernel is parametric (no weight shape carries it): it comes
    # from the fallback dims, as in the JAX package.
    fallback = tpyannet.PyannetDims(sinc_kernel=GOLD_PYANNET.sinc_kernel)
    dims = tpyannet.infer_pyannet_dims(tree_t, fallback)
    assert dataclasses.asdict(dims) == dataclasses.asdict(GOLD_PYANNET)
    assert tpyannet.infer_pyannet_dims(tree_t).sinc_kernel == 251
    x = _clips(6, 2, SR, 0.2)
    ours = tpyannet.pyannet_forward(
        tpyannet.pyannet_from_jax_params(tree_t, dims, "cpu"),
        torch.from_numpy(x), dims)
    ref = jpyannet.pyannet_forward(jax.tree.map(jnp.asarray, tree_j),
                                   jnp.asarray(x), GOLD_PYANNET)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_converters_load_checkpoints_from_disk(tmp_path):
    """The bundle's loaders read speechbrain and pyannote files from a model
    directory (converted, dims inferred) and name their source."""
    edir = tmp_path / "embedding"
    sdir = tmp_path / "segmentation"
    edir.mkdir()
    sdir.mkdir()
    esd = _make_ecapa_sd(np.random.default_rng(8))
    psd, _ = _make_pyannet_sd(np.random.default_rng(9))
    torch.save(esd, str(edir / "embedding_model.ckpt"))
    torch.save({"state_dict": psd, "hyper_parameters": {}},
               str(sdir / "pytorch_model.bin"))
    b = ModelBundle(model_dir=str(tmp_path), device="cpu")
    b._ecapa = b._load_ecapa()
    b._pyannet = b._load_pyannet()
    assert b.load_source == {"ecapa": "checkpoint", "pyannet": "checkpoint"}
    assert dataclasses.asdict(b._pyannet_dims) == dataclasses.asdict(
        dataclasses.replace(GOLD_PYANNET, sinc_kernel=251))
    assert b._ecapa_dims.embedding_dim == GOLD_ECAPA.embedding_dim
    b._loaded = True
    assert b.embed_batch(_clips(1, 1, 8000)).shape == (1, 16)


def test_seeded_init_is_device_independent_and_full_width():
    a = tpyannet.init_pyannet_params(3)
    b = tpyannet.init_pyannet_params(3)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)
    assert a["sincnet"]["conv1"]["w"].shape == (5, 80, 60)
    assert a["lstm"][1]["fwd"]["w_ih"].shape == (256, 512)
    e = tecapa.init_ecapa_params(2)
    assert e["mfa"]["w"].shape == (1, 1536, 1536)
    assert e["fc"]["w"].shape == (1, 3072, 192)


# ---------------------------------------------------------------- bundle

def _make_store(b, files):
    T = max(len(f) for f in files)
    batch = np.zeros((len(files), T), np.float32)
    for i, f in enumerate(files):
        batch[i, : len(f)] = f
    return b.make_store(batch, SR)


def test_bundle_embed_batch_and_denoised_match_jax(bundles):
    jb, tb = bundles
    x = _clips(7, 3, 16000)
    lens = np.array([16000, 9000, 5000])
    np.testing.assert_allclose(tb.embed_batch(x, lens),
                               jb.embed_batch(x, lens), atol=1e-4)
    np.testing.assert_allclose(tb.embed_batch(x), jb.embed_batch(x),
                               atol=1e-4)
    x[1, 9000:] = 0.0
    x[2, 5000:] = 0.0
    np.testing.assert_allclose(tb.embed_denoised_batch(x, lens, 0.4),
                               jb.embed_denoised_batch(x, lens, 0.4),
                               atol=1e-4)


def test_bundle_segment_frames_matches_jax(bundles):
    jb, tb = bundles
    x = _clips(8, 3, 2 * SR)
    got = tb.segment_frames(x)
    np.testing.assert_allclose(got, jb.segment_frames(x), atol=1e-5)
    assert got.shape[0] == 3 and got.shape[2] == 3
    assert tb.frame_hop_seconds == jb.frame_hop_seconds


def test_bundle_store_variants_equal_host(bundles):
    """embed_store, embed_denoised_store (with the raw windows' variance),
    segment_frames_store and embed_frames_store equal their host versions
    (rtol 1e-5, atol 1e-6, tests/test_store.py)."""
    _, tb = bundles
    files = [_clips(9, 1, 8 * SR)[0], _clips(10, 1, 6 * SR)[0]]
    store = _make_store(tb, files)
    rows, starts, lens = [0, 1, 1], [1000, 0, 40000], [16000, 12000, 7000]
    host = np.zeros((3, 16000), np.float32)
    for k, (r, s, n) in enumerate(zip(rows, starts, lens)):
        host[k, :n] = files[r][s: s + n]
    kw = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.embed_store(store, rows, starts, lens,
                                              16000),
                               tb.embed_batch(host, np.array(lens)), **kw)
    emb, var = tb.embed_denoised_store(store, rows, starts, lens, 0.5, 16000,
                                       with_var=True)
    np.testing.assert_allclose(emb, tb.embed_denoised_batch(
        host, np.array(lens), 0.5), **kw)
    np.testing.assert_allclose(
        var, [np.var(host[k, :n]) for k, n in enumerate(lens)], rtol=1e-5)
    np.testing.assert_allclose(
        tb.embed_denoised_store(store, rows, starts, lens, 0.5, 16000), emb,
        **kw)

    win = 2 * SR
    seg_host = np.zeros((2, win), np.float32)
    seg_host[0] = files[0][:win]
    seg_host[1, : 6 * SR - 5 * SR] = files[1][5 * SR:]
    np.testing.assert_allclose(
        tb.segment_frames_store(store, [0, 1], [0, 5 * SR], win),
        tb.segment_frames(seg_host), **kw)

    fr, pad = 270, 3 * SR
    F = -(-pad // fr)
    starts0 = np.asarray([k * fr for k in range(0, 40, 4)])
    starts1 = np.asarray([k * fr for k in range(200)])
    fstarts = np.zeros((2, F), np.int32)
    fstarts[0, : len(starts0)] = starts0
    fstarts[1, :] = starts1[:F]
    totals = np.asarray([len(starts0) * fr, pad], np.int32)
    got = tb.embed_frames_store(store, [0, 1], fstarts, totals, fr, pad)
    fh = np.zeros((2, pad), np.float32)
    clip0 = np.concatenate([files[0][s: s + fr] for s in starts0])
    fh[0, : len(clip0)] = clip0
    fh[1] = np.concatenate([files[1][s: s + fr] for s in starts1])[:pad]
    np.testing.assert_allclose(got, tb.embed_batch(fh, np.asarray(
        [len(clip0), pad])), **kw)


def test_bundle_store_methods_match_jax(bundles):
    jb, tb = bundles
    files = [_clips(11, 1, 7 * SR)[0], _clips(12, 1, 5 * SR)[0]]
    ts, js = _make_store(tb, files), _make_store(jb, files)
    rows, starts, lens = [1, 0], [3000, 20000], [12000, 16000]
    np.testing.assert_allclose(tb.embed_store(ts, rows, starts, lens, 16000),
                               jb.embed_store(js, rows, starts, lens, 16000),
                               atol=1e-4)
    e_t, v_t = tb.embed_denoised_store(ts, rows, starts, lens, 0.3, 16000,
                                       with_var=True)
    e_j, v_j = jb.embed_denoised_store(js, rows, starts, lens, 0.3, 16000,
                                       with_var=True)
    np.testing.assert_allclose(e_t, e_j, atol=1e-4)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-5)
    np.testing.assert_allclose(
        tb.segment_frames_store(ts, [0, 0, 1], [0, 2 * SR, SR], 2 * SR),
        jb.segment_frames_store(js, [0, 0, 1], [0, 2 * SR, SR], 2 * SR),
        atol=1e-5)


def test_bundle_cancel_gate(bundles):
    from clearconverse_tpu_torch.pipeline.cancel import ProcessingCancelled
    _, tb = bundles
    tb.should_cancel = lambda: True
    try:
        with pytest.raises(ProcessingCancelled):
            tb.embed_batch(_clips(0, 1, 8000))
        with pytest.raises(ProcessingCancelled):
            tb.transcribe_batch(_clips(0, 1, 8000), [""])
    finally:
        tb.should_cancel = None


# ---------------------------------------------------------------- diarize

def test_file_activities_and_diarize_many_store_equal_host(bundles):
    from clearconverse_tpu_torch.pipeline.diarize import (
        diarize_many, file_activities)
    _, tb = bundles
    files = [_clips(13, 1, 20 * SR)[0], _clips(14, 1, 14 * SR)[0]]
    store = _make_store(tb, files)
    with_store = file_activities(tb, files, SR, store=store,
                                 store_rows=[0, 1])
    without = file_activities(tb, files, SR)
    for (a, ha), (b, hb) in zip(with_store, without):
        assert ha == hb
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    fhop = tb.frame_hop_seconds

    def act_for(n):
        act = np.zeros((int(n / SR / fhop), 3), np.float32)
        a, b = int(3.0 / fhop), int(6.0 / fhop)
        act[:b, 0] = 0.9
        act[a:, 1] = 0.9              # 3-6 s mixed → a contiguous clip
        return act, fhop

    kw = dict(min_speakers=1, max_speakers=2,
              activities=[act_for(len(f)) for f in files])
    got = diarize_many(tb, files, SR, store=store, store_rows=[0, 1], **kw)
    assert got == diarize_many(tb, files, SR, **kw)
    assert all(got)


def test_file_activities_match_jax(bundles):
    from clearconverse_tpu.pipeline.diarize import file_activities as jfa
    from clearconverse_tpu_torch.pipeline.diarize import file_activities
    jb, tb = bundles
    files = [_clips(15, 1, 17 * SR)[0]]
    (a, ha), = file_activities(tb, files, SR)
    (b, hb), = jfa(jb, files, SR)
    assert ha == hb
    np.testing.assert_allclose(a, b, atol=1e-5)


def test_diarize_with_crafted_pyannet_matches_jax():
    """tests/test_engine.py:735's case on the port: crafted frequency-
    selective PyanNet, tiny ECAPA (the JAX PRNGKey(38) weights), lowered
    hysteresis and cluster threshold → the same labeled segments as the JAX
    diarize, two speakers and one detected overlap at 9.5-11.5 s."""
    from clearconverse_tpu.pipeline.bundle import ModelBundle as JBundle
    from clearconverse_tpu.pipeline.dev_backend import (
        craft_pyannet_freq_params as j_craft)
    from clearconverse_tpu.pipeline.diarize import diarize as jdiarize
    from clearconverse_tpu_torch.pipeline import segments as S
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        craft_pyannet_freq_params, synth_conversation)
    from clearconverse_tpu_torch.pipeline.diarize import diarize

    edims = jecapa.EcapaDims(n_mels=24, channels=32, mfa_channels=48,
                             attention_channels=16, embedding_dim=16,
                             res2net_scale=4)
    kw = dict(onset=0.35, offset=0.25, cluster_threshold=0.30)
    jb = JBundle(JConfig(), TPUConfig(compute_dtype="float32"))
    jb._ecapa = jecapa.init_ecapa_params(jax.random.PRNGKey(38), edims)
    jb._ecapa_dims = edims
    jb._pyannet, jb._pyannet_dims = j_craft()
    jb._loaded = True
    tb = ModelBundle(torch_config=TorchConfig(compute_dtype="float32"),
                     device="cpu")
    tb._ecapa = tecapa.ecapa_from_jax_params(_np_tree(jb._ecapa), "cpu")
    tb._ecapa_dims = tecapa.EcapaDims(**dataclasses.asdict(edims))
    tb._pyannet, tb._pyannet_dims = craft_pyannet_freq_params(device="cpu")
    tb._loaded = True
    assert dataclasses.asdict(tb._pyannet_dims) == \
        dataclasses.asdict(jb._pyannet_dims)

    audio = synth_conversation()
    ours = diarize(tb, audio, SR, 1, 2, **kw)
    ref = jdiarize(jb, audio, SR, 1, 2, **kw)
    assert ours == ref
    assert len({s for _, _, s in ours}) == 2
    ov = S.detect_overlap_regions(ours, 0.5)
    assert len(ov) == 1 and abs(ov[0][0] - 9.5) < 0.2 and abs(ov[0][1] - 11.5) < 0.2


# ---------------------------------------------------------------- long form

def test_transcribe_long_batch_matches_jax(bundles):
    """The >30 s seek path on a 45 s row (host, with a 24 s second row) and
    on store windows, at t=0 f32: identical (text, advance, reset, ids)."""
    jb, tb = bundles
    audio = np.zeros((2, 45 * SR), np.float32)
    audio[0] = _clips(16, 1, 45 * SR)[0]
    audio[1, : 24 * SR] = _clips(17, 1, 24 * SR)[0]
    lens = np.array([30 * SR, 24 * SR])
    prompts = ["", ("context words", [50364, 300, 301])]
    ours = tb.transcribe_long_batch(audio, prompts, lens)
    ref = jb.transcribe_long_batch(audio, prompts, lens)
    assert ours == ref
    assert all(0 < adv <= 30.0 for _, adv, _, _ in ours)
    assert any(ids for _, _, _, ids in ours)

    ts, js = _make_store(tb, list(audio)), _make_store(jb, list(audio))
    from clearconverse_tpu.pipeline.bundle import StoreBatch as JStoreBatch
    from clearconverse_tpu_torch.pipeline.bundle import StoreBatch
    sb = StoreBatch(ts, [0, 1], [15 * SR, 0], [30 * SR, 24 * SR], 30 * SR)
    jsb = JStoreBatch(js, [0, 1], [15 * SR, 0], [30 * SR, 24 * SR], 30 * SR)
    assert tb.transcribe_long_batch(sb, ["", "x"]) == \
        jb.transcribe_long_batch(jsb, ["", "x"])


def test_timestamp_rules_match_jax(rng):
    """_timestamp_rules on random logits and token histories equals the JAX
    rule (first step, open and closed pairs, monotonicity, the forcing
    rule)."""
    from clearconverse_tpu.models.decoding import DecodeOptions as JOpts
    from clearconverse_tpu.models.decoding import _timestamp_rules as jrules
    from clearconverse_tpu_torch.models.decoding import DecodeOptions, _timestamp_rules

    V, tsb, eot = 600, 500, 450
    opts = DecodeOptions(eot=eot, timestamps=True, timestamp_begin=tsb,
                         max_initial_timestamp_index=20)
    jopts = JOpts(eot=eot, timestamps=True, timestamp_begin=tsb,
                  max_initial_timestamp_index=20)
    logits = rng.standard_normal((6, V)).astype(np.float32) * 3
    logits[3, tsb:] += 6.0                           # timestamps dominate
    prev = np.array([510, 510, 20, 530, -1, 505])
    prev2 = np.array([20, 505, 510, 540, -1, -1])
    last = np.array([510, 510, 510, 530, -1, 505])
    for first in (True, False):
        for step in (1, 5):
            ours = _timestamp_rules(
                torch.from_numpy(logits), opts, first,
                *(torch.from_numpy(a) for a in (prev, prev2, last)), step)
            ref = jrules(jnp.asarray(logits), jopts, first,
                         *(jnp.asarray(a, jnp.int32) for a in (prev, prev2,
                                                                 last)),
                         jnp.int32(step))
            np.testing.assert_array_equal(ours.numpy() <= -1e8,
                                          np.asarray(ref) <= -1e8)
