"""int4 cross-KV in the port against the JAX package (f32, CPU): the codes
and scales of ``precompute_cross_kv(bits=4)``, unpacked from their two-a-byte
layout, equal JAX's ``jnp.int4`` codes at even and odd T; prefill logits and
greedy tokens agree with the JAX decoder at ``cross_kv_bits=4``; the engine
runs with ``CC_TORCH_CROSS_KV_BITS=4``; other widths still raise."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from clearconverse_tpu.models import decoding as jdec
from clearconverse_tpu.models import whisper as jw

from clearconverse_tpu_torch.models import decoding as tdec
from clearconverse_tpu_torch.models import whisper as tw
from clearconverse_tpu_torch.models.convert import whisper_from_jax_params

torch.set_num_threads(1)

KW = dict(n_mels=80, n_vocab=51864, n_audio_ctx=1500, n_audio_state=64,
          n_audio_head=2, n_audio_layer=1, n_text_ctx=448, n_text_state=64,
          n_text_head=2, n_text_layer=2)
JDIMS, TDIMS = jw.WhisperDims(**KW), tw.WhisperDims(**KW)
EOT, SOT, NO_SPEECH = 50256, 50257, 50361
SUPPRESS = tuple(range(SOT, 51864))
TARGET = 2 * 16000
MT = 10


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def weights():
    params = jax.tree.map(np.asarray,
                          jw.init_whisper_params(jax.random.PRNGKey(0), JDIMS))
    return params, whisper_from_jax_params(params, TDIMS, "cpu")


def _opts(mod, **kw):
    base = dict(max_tokens=MT, eot=EOT, suppress_tokens=SUPPRESS,
                no_speech_token=NO_SPEECH, sot_from_end=2, cross_kv_bits=4)
    base.update(kw)
    return mod.DecodeOptions(**base)


@pytest.mark.parametrize("t", [25, 24, 1])
def test_int4_codes_and_scales_equal_jax(weights, t):
    """Same encoder output on both sides: unpacked codes identical to JAX's
    int4 codes, scales within 1e-6; the packed bytes hold ceil(T/2) columns
    of K and dh/2 of V, and the batch axis is unchanged."""
    params, model = weights
    audio = (np.random.default_rng(t).standard_normal((3, t, 64))
             .astype(np.float32))
    ref = jw.precompute_cross_kv(params, jnp.asarray(audio), bits=4, n_head=2)
    ours = tw.precompute_cross_kv(model, torch.from_numpy(audio), n_head=2,
                                  bits=4)
    for r, o in zip(ref, ours):
        for name in ("k8t", "v8t"):
            rq = np.asarray(r[name]["q"]).astype(np.int8)
            assert o[name]["q4"].dtype == torch.int8
            assert o[name]["q4"].shape[:-1] == rq.shape[:-1]
            assert o[name]["q4"].shape[-1] == -(-rq.shape[-1] // 2)
            codes = tw.unpack_codes(o[name]).numpy()
            np.testing.assert_array_equal(codes, rq)
            assert np.abs(codes).max() <= 7
            np.testing.assert_allclose(o[name]["scale"].numpy(),
                                       np.asarray(r[name]["scale"]),
                                       rtol=1e-6, atol=1e-6)


def test_int4_pack_round_trips_every_code():
    """Every pair of codes in [-8, 7], at an even and an odd length."""
    a = torch.arange(-8, 8, dtype=torch.int8)
    grid = torch.stack(torch.meshgrid(a, a, indexing="ij"), -1).reshape(-1, 2)
    for n in (2, 1):
        q = grid[:, :n].contiguous()
        packed = tw.pack_int4(q)
        assert packed.shape == (q.shape[0], 1)
        out = tw.unpack_codes({"q4": packed, "n": n, "scale": None})
        assert torch.equal(out, q)


def test_int4_prefill_logits_match_jax(weights):
    """Encode → int4 cross-KV → prompt prefill, f32 logits within the int8
    test's 5e-4 (tests/test_torch_whisper.py)."""
    params, model = weights
    mel = (np.random.default_rng(2).standard_normal((2, 80, 200))
           .astype(np.float32))
    toks = np.array([[0, 5, 9, 11], [3, 7, 2, 8]], np.int32)
    lens = np.array([3, 4], np.int32)
    ref = np.asarray(jdec._prefill(params, jnp.asarray(mel), jnp.asarray(toks),
                                   jnp.asarray(lens), JDIMS,
                                   _opts(jdec, max_tokens=6), 4)[3])
    ours = tdec._prefill(model, torch.from_numpy(mel),
                         torch.from_numpy(toks).long(),
                         torch.from_numpy(lens).long(), TDIMS,
                         _opts(tdec, max_tokens=6), 4)[2]
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=5e-4)


def test_int4_greedy_tokens_match_jax(weights):
    """2-layer decoder, f32, t=0: identical tokens and lengths."""
    params, model = weights
    audio = (np.random.default_rng(0).standard_normal((3, 24000))
             .astype(np.float32) * 0.1)
    lists = [[50360, 11, 22, SOT, 50362], [SOT, 50362], [50360, 7, SOT, 50362]]
    toks, lens = jdec.build_prompt_batch(lists, 16, EOT)
    ref = jdec.greedy_decode_from_audio(
        params, jnp.asarray(audio), jnp.asarray(toks), jnp.asarray(lens),
        JDIMS, _opts(jdec), 16, target_len=TARGET)
    ours = tdec.greedy_decode_from_audio(
        model, torch.from_numpy(audio), torch.from_numpy(toks),
        torch.from_numpy(lens), TDIMS, _opts(tdec), 16, target_len=TARGET)
    np.testing.assert_array_equal(ours["tokens"].numpy(),
                                  np.asarray(ref["tokens"]))
    np.testing.assert_array_equal(ours["lengths"].numpy(),
                                  np.asarray(ref["lengths"]))
    assert (np.asarray(ref["tokens"]) != EOT).any()


@pytest.mark.parametrize("bits", [2, 3, 32])
def test_other_cross_kv_widths_raise(weights, bits):
    _, model = weights
    audio = torch.zeros((1, 4, 64))
    with pytest.raises(ValueError):
        tw.precompute_cross_kv(model, audio, n_head=2, bits=bits)


def test_engine_runs_with_int4_cross_kv_from_env(tmp_path, monkeypatch):
    """CC_TORCH_CROSS_KV_BITS=4 reaches the decode through the engine's
    process_files on the CPU, and the file comes back with text."""
    from clearconverse_tpu_torch.audio.wav import write_wav
    from clearconverse_tpu_torch.config import Config, torch_config_from_env
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.ecapa import EcapaDims, init_ecapa
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        craft_pyannet_freq_params, synth_conversation)
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

    tc = torch_config_from_env({"CC_TORCH_CROSS_KV_BITS": "4",
                                "CC_TORCH_COMPUTE_DTYPE": "float32"})
    assert tc.cross_kv_bits == 4
    tc.max_decode_tokens = 4
    dims = tw.WhisperDims(n_audio_state=64, n_audio_head=2, n_audio_layer=1,
                          n_text_state=64, n_text_head=2, n_text_layer=1)
    b = ModelBundle(torch_config=tc, device="cpu")
    b._whisper = (init_whisper(dims, 0, "cpu"), dims, ByteFallbackTokenizer())
    edims = EcapaDims(n_mels=24, channels=32, mfa_channels=48,
                      attention_channels=16, embedding_dim=16, res2net_scale=4)
    b._ecapa, b._ecapa_dims = init_ecapa(edims, 1, "cpu"), edims
    b._pyannet, b._pyannet_dims = craft_pyannet_freq_params(device="cpu")
    b._loaded = True
    widths = []
    orig = tdec.precompute_cross_kv

    def spy(*a, **kw):
        widths.append(kw["bits"])
        return orig(*a, **kw)

    path = tmp_path / "short.wav"
    write_wav(str(path), synth_conversation()[: 9 * 16000], 16000)
    monkeypatch.setattr(tdec, "precompute_cross_kv", spy)
    res, = TranscriptionEngine(Config(noise_reduction_amount=0.2), tc,
                               models=b).process_files([str(path)])
    assert res is not None and res["segments"]
    assert widths and set(widths) == {4}
