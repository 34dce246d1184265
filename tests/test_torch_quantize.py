"""Int8 decoder weights (ops/quantize.py) against the JAX package's
ops/quantize.py on the same weights (f32, CPU, one torch thread): codes and
scales identical, dense_quantized within 1e-5, the quantized decoder's
structure, and greedy_decode with a quantized decoder token for token
against JAX's at t=0, at tests/test_quantize.py's TINY dims."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from clearconverse_tpu.models import decoding as jdec
from clearconverse_tpu.models import whisper as jw
from clearconverse_tpu.ops import quantize as jq

from clearconverse_tpu_torch.models import decoding as tdec
from clearconverse_tpu_torch.models.convert import whisper_from_jax_params
from clearconverse_tpu_torch.models.whisper import WhisperDims, dense
from clearconverse_tpu_torch.ops import quantize as tq

KW = dict(n_mels=16, n_vocab=64, n_audio_ctx=25, n_audio_state=32,
          n_audio_head=4, n_audio_layer=1, n_text_ctx=24, n_text_state=32,
          n_text_head=4, n_text_layer=2)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, jw.init_whisper_params(
        jax.random.PRNGKey(0), jw.WhisperDims(**KW)))


def _linear(w_kn: np.ndarray, b: np.ndarray = None) -> torch.nn.Linear:
    """An nn.Linear holding a JAX-layout [in, out] weight."""
    lin = torch.nn.Linear(*w_kn.shape, bias=b is not None)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w_kn.T))
        if b is not None:
            lin.bias.copy_(torch.from_numpy(b))
    return lin


def test_codes_and_scales_equal_jax(rng):
    # Half-way values too: both round half to even.
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    w[0, :4] = [0.5, 1.5, -2.5, 3.5]
    ref = jq.quantize_weight(jnp.asarray(w))
    got = tq.quantize_weight(torch.from_numpy(w.T.copy()))
    assert got["wq"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["wq"].numpy().T, np.asarray(ref["wq"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(ref["scale"]))
    deq = got["wq"].float() * got["scale"][:, None]
    err = (deq - torch.from_numpy(w.T)).abs() / got["scale"][:, None]
    assert float(err.max()) <= 0.5 + 1e-3


def test_dense_quantized_matches_jax(rng):
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(48) * 0.01).astype(np.float32)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    ref = jq.dense_quantized(jnp.asarray(x), {**jq.quantize_weight(
        jnp.asarray(w)), "b": jnp.asarray(b)})
    qlin = tq.QuantizedLinear.from_linear(_linear(w, b))
    got = tq.dense_quantized(torch.from_numpy(x), qlin)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # dense() dispatches on the int8 linear, with and without the bias.
    torch.testing.assert_close(dense(torch.from_numpy(x), qlin), got)
    np.testing.assert_allclose(
        dense(torch.from_numpy(x), qlin, bias=False).numpy(),
        np.asarray(ref) - b, atol=1e-5)


def test_quantize_decoder_structure(params):
    model = whisper_from_jax_params(params, WhisperDims(**KW), "cpu")
    q = tq.quantize_whisper_decoder(model)
    blk = q.decoder.blocks[0]
    for group in (blk.attn, blk.cross):
        for name in ("q", "k", "v", "out"):
            assert isinstance(getattr(group, name), tq.QuantizedLinear)
    assert blk.attn.q.bias is not None and blk.attn.k.bias is None
    assert isinstance(blk.mlp.fc2, tq.QuantizedLinear)
    # Encoder, embeddings and layer norms untouched and shared.
    assert isinstance(q.encoder.blocks[0].attn.q, torch.nn.Linear)
    assert q.decoder.tok is model.decoder.tok
    assert blk.attn_ln.weight is model.decoder.blocks[0].attn_ln.weight
    # The input module keeps its float linears.
    assert isinstance(model.decoder.blocks[0].attn.q, torch.nn.Linear)
    # The codes are the JAX package's for the same weights.
    jqp = jq.quantize_whisper_decoder(params)
    for i, jblk in enumerate(jqp["decoder"]["blocks"]):
        tblk = q.decoder.blocks[i]
        for group, name in (("attn", "q"), ("cross", "v"), ("mlp", "fc1")):
            got = getattr(getattr(tblk, group), name)
            np.testing.assert_array_equal(got.wq.numpy().T,
                                          np.asarray(jblk[group][name]["wq"]))


def test_greedy_decode_quantized_tokens_equal_jax(params, rng):
    """A quantized decoder's greedy decode, t=0 f32: the JAX package's
    tokens, and valid ids."""
    dims = WhisperDims(**KW)
    mel = (rng.standard_normal((2, 16, 50)) * 0.3).astype(np.float32)
    toks, lens = jdec.build_prompt_batch([[1], [1]], 1, pad_id=0)
    ref = jdec.greedy_decode(jq.quantize_whisper_decoder(params),
                             jnp.asarray(mel), jnp.asarray(toks),
                             jnp.asarray(lens), jw.WhisperDims(**KW),
                             jdec.DecodeOptions(max_tokens=8, eot=63,
                                                suppress_blank=False), 1)
    model = tq.quantize_whisper_decoder(
        whisper_from_jax_params(params, dims, "cpu"))
    got = tdec.greedy_decode(model, torch.from_numpy(mel),
                             torch.from_numpy(toks), torch.from_numpy(lens),
                             dims, tdec.DecodeOptions(max_tokens=8, eot=63,
                                                      suppress_blank=False), 1)
    tokens = got["tokens"].numpy()
    assert ((tokens >= 0) & (tokens < 64)).all()
    np.testing.assert_array_equal(tokens, np.asarray(ref["tokens"]))
    np.testing.assert_allclose(got["sum_logprob"].numpy(),
                               np.asarray(ref["sum_logprob"]), atol=1e-4)
