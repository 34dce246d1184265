"""The port's word-timestamp alignment (models/alignment.py and
ModelBundle.transcribe_batch(word_timestamps=True)) against the JAX package
on the same weights and inputs, f32, t=0: cross-attention weights within
1e-5, identical DTW paths, and identical words and times, on the setup of
tests/test_alignment.py."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from clearconverse_tpu.models import alignment as J
from clearconverse_tpu.models.tokenizer import ByteFallbackTokenizer as JTok
from clearconverse_tpu.models.whisper import WhisperDims as JDims
from clearconverse_tpu.models.whisper import init_whisper_params, whisper_encode

from clearconverse_tpu_torch.models import alignment as P
from clearconverse_tpu_torch.models.convert import whisper_from_jax_params
from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
from clearconverse_tpu_torch.models.whisper import WhisperDims

torch.set_num_threads(1)

TINY = JDims(n_mels=16, n_vocab=300, n_audio_ctx=25, n_audio_state=32,
             n_audio_head=4, n_audio_layer=2, n_text_ctx=16, n_text_state=32,
             n_text_head=4, n_text_layer=2)
PTINY = WhisperDims(**dataclasses.asdict(TINY))


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def tiny():
    """JAX params, the port model holding them, and encoder features of
    two random mel rows (the JAX encoder's output feeds both sides)."""
    params = jax.tree.map(np.asarray,
                          init_whisper_params(jax.random.PRNGKey(0), TINY))
    model = whisper_from_jax_params(params, PTINY, "cpu")
    mel = (np.random.default_rng(0).standard_normal((2, 16, 50))
           .astype(np.float32) * 0.3)
    feats = np.asarray(whisper_encode(params, jnp.asarray(mel), TINY))
    return params, model, feats


@pytest.mark.parametrize("toks", [[[1, 5, 9]], [[1, 5, 9, 100, 7, 7, 299],
                                                 [3, 4, 250, 0, 0, 0, 0]]])
def test_cross_attention_weights_match_jax(tiny, toks):
    params, model, feats = tiny
    toks = np.asarray(toks, np.int32)
    audio = feats[: len(toks)]
    ref = np.asarray(J.cross_attention_weights(params, jnp.asarray(toks),
                                               jnp.asarray(audio), TINY))
    ours = P.cross_attention_weights(model, torch.as_tensor(toks).long(),
                                     torch.tensor(audio), PTINY).numpy()
    assert ours.shape == ref.shape == (len(toks), toks.shape[1], 25)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_dtw_path_identical(seed):
    rng = np.random.default_rng(seed)
    T, F = int(rng.integers(1, 14)), int(rng.integers(1, 60))
    attn = rng.random((T, F))
    if seed % 2:                       # ties exercise the candidate order
        attn = np.round(attn, 1)
    assert P.dtw_path(attn) == J.dtw_path(attn)
    assert P.token_times(attn, T) == J.token_times(attn, T)


def test_word_timestamps_identical():
    ids = ByteFallbackTokenizer().encode("hi there, you")
    times = [(0.1 * i, 0.1 * i + 0.1) for i in range(len(ids))]
    assert (P.word_timestamps(ByteFallbackTokenizer(), ids, times)
            == J.word_timestamps(JTok(), ids, times))


@pytest.mark.parametrize("prefixes,eot,sot", [
    (None, -1, 1),                              # bare [sot], no eot
    ([[1, 2, 3, 4], [1, 2, 3, 4]], 9, -1),      # the full SOT replay
    ([[1, 2], [7]], 9, -1)])                    # ragged prefixes
def test_align_batch_identical(tiny, prefixes, eot, sot):
    params, model, feats = tiny
    tokens = np.zeros((2, 8), np.int32)
    text = b"ab cd"
    tokens[0, : len(text)] = list(text)
    tokens[1, :2] = [120, 121]
    lengths = np.asarray([len(text), 2])
    ref = J.align_batch(params, JTok(), tokens, lengths, jnp.asarray(feats),
                        TINY, sot=sot, prefixes=prefixes, eot=eot)
    ours = P.align_batch(model, ByteFallbackTokenizer(), tokens, lengths,
                         torch.tensor(feats), PTINY, sot=sot,
                         prefixes=prefixes, eot=eot)
    assert ours == ref
    assert [w["word"] for w in ours[0]] == ["ab", "cd"]


# ------------------------------------------------ the bundle, word timestamps

@pytest.fixture(scope="module")
def bundles():
    from test_torch_bundle import KNOBS, KW
    from clearconverse_tpu.config import Config as JConfig, TPUConfig
    from clearconverse_tpu.pipeline.bundle import ModelBundle as JBundle

    from clearconverse_tpu_torch.config import TorchConfig
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle

    params = jax.tree.map(np.array, init_whisper_params(
        jax.random.PRNGKey(0), JDims(**KW)))
    # Every token row but the 256 byte ids and EOT shrinks 100x, so the
    # decode emits bytes the tokenizer renders as words and the no-speech
    # gate (which would blank them) stays shut.
    params["decoder"]["tok"][256:50256] *= 0.01
    params["decoder"]["tok"][50257:] *= 0.01
    jb = JBundle(JConfig(), TPUConfig(**KNOBS))
    jb._whisper = (params, JDims(**KW), JTok(english=True))
    jb._loaded = True
    tb = ModelBundle(torch_config=TorchConfig(**KNOBS), device="cpu")
    tb._whisper = (whisper_from_jax_params(params, WhisperDims(**KW), "cpu"),
                   WhisperDims(**KW), ByteFallbackTokenizer(english=True))
    tb._loaded = True
    return jb, tb


def _audio(n, t, seed):
    return (np.random.default_rng(seed).standard_normal((n, t))
            .astype(np.float32) * 0.1)


@pytest.mark.parametrize("n,store", [(1, False), (3, False), (3, True)])
def test_transcribe_batch_word_timestamps_match_jax(bundles, n, store):
    """texts and words (with times) identical at t=0 f32; the padded rows
    of a 3-row call align with length 0 and are dropped; every word lies
    inside the 30 s window with start <= end."""
    from clearconverse_tpu.pipeline.bundle import StoreBatch as JStoreBatch

    from clearconverse_tpu_torch.pipeline.bundle import StoreBatch

    jb, tb = bundles
    audio = _audio(n, 24000, seed=n + 3)
    prompts = ["a prompt", "", "more words"][:n]
    if store:
        full = _audio(1, 60000, seed=9)
        starts = [0, 12000, 30000][:n]
        ours = tb.transcribe_batch(
            StoreBatch(tb.make_store(full, 16000), [0] * n, starts,
                       [24000] * n, 24000),
            prompts, temperature=0.0, word_timestamps=True)
        ref = jb.transcribe_batch(
            JStoreBatch(jb.make_store(jnp.asarray(full), 16000), [0] * n,
                        starts, [24000] * n, 24000),
            prompts, temperature=0.0, word_timestamps=True)
    else:
        ours = tb.transcribe_batch(audio, prompts, temperature=0.0,
                                   word_timestamps=True)
        ref = jb.transcribe_batch(audio, prompts, temperature=0.0,
                                  word_timestamps=True)
    texts, words = ours
    assert (texts, words) == (ref[0], ref[1])
    assert len(words) == n and any(words)
    for row in words:
        for w in row:
            assert 0.0 <= w["start"] <= w["end"] <= 30.0
