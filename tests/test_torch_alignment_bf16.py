"""The word-timestamp pass at the default bf16, held to the JAX package's
own bf16 (the contract of tests/test_torch_bf16.py: no further from JAX
f32 than JAX's bf16 is).

What the pass computes in. Both bundles call ``align_batch`` without a
``compute_dtype``, so ``cross_attention_weights`` runs at its f32 default
in both packages: an f32 residual stream, f32 layer norms, products and
softmax. At the default bf16 only its inputs differ from an f32 run: the
encoder features come from the bf16 encoder, the cross K/V are projected
from them in bf16 (one rounding, in both packages), and the weights are
those the bundle stores, f32 in the JAX package (it loads checkpoints as
f32 and casts per product) and bf16 in the port (it loads them in the
compute dtype). The pass has no bf16 residual stream.

Held here, on the tiny seeded Whisper and noise rows of
tests/test_torch_bf16.py (token rows 256-50255 and the specials scaled by
0.01, as tests/test_torch_alignment.py does, so the decode emits bytes
and the no-speech gate stays shut), t=0, each package against JAX f32:

- through the bundles (``transcribe_batch(word_timestamps=True)``), and
  through ``align_batch`` on seeded byte words (6 a row), the words whose
  text differs or whose start or end moves by more than one 20 ms frame:
  the port's count at most JAX bf16's + 4;
- the averaged cross-attention of one teacher batch: mean |Δ| at most
  1.25x JAX bf16's.

On this setup (CPU), words off JAX f32 by more than a frame, JAX bf16
against the port's bf16: through the bundles 0 and 0 of 16 (the seeded
decode gives one word a row), through align_batch 2 and 4 of 96; attention
mean |Δ| 2.36e-6 and 2.41e-6 (1.02x).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_bf16 import EOT, KW, SOT

from clearconverse_tpu.config import Config as JConfig
from clearconverse_tpu.config import TPUConfig
from clearconverse_tpu.models import alignment as ja
from clearconverse_tpu.models import whisper as jw
from clearconverse_tpu.models.tokenizer import ByteFallbackTokenizer as JTok
from clearconverse_tpu.pipeline.bundle import ModelBundle as JBundle

from clearconverse_tpu_torch.audio.mel import log_mel_auto, pad_or_trim
from clearconverse_tpu_torch.config import TorchConfig
from clearconverse_tpu_torch.models import alignment as ta
from clearconverse_tpu_torch.models import whisper as tw
from clearconverse_tpu_torch.models.convert import whisper_from_jax_params
from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
from clearconverse_tpu_torch.pipeline.bundle import ModelBundle

JDIMS, TDIMS = jw.WhisperDims(**KW), tw.WhisperDims(**KW)
NO_TS = 50362
ROWS = 16
FRAME_S = 0.02
WORD_SLACK = 4             # words off JAX f32, over JAX bf16's count
DRIFT_RATIO = 1.25         # attention drift over JAX bf16's
KNOBS = dict(max_decode_tokens=12, max_fallback_attempts=1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def setup():
    """JAX seed-0 weights (token rows scaled), the port's model as its
    bundle stores it at bf16, ROWS rows of 1.5 s noise and their log-mel."""
    torch.set_num_threads(1)
    params = jax.tree.map(np.array,
                          jw.init_whisper_params(jax.random.PRNGKey(0), JDIMS))
    params["decoder"]["tok"][256:50256] *= 0.01
    params["decoder"]["tok"][50257:] *= 0.01
    model = whisper_from_jax_params(params, TDIMS, "cpu", torch.bfloat16)
    audio = (np.random.default_rng(0).standard_normal((ROWS, 24000))
             .astype(np.float32) * 0.1)
    mel = log_mel_auto(pad_or_trim(torch.from_numpy(audio), 30 * 16000), 80)
    return params, model, audio, mel


def _words_off(words, ref) -> int:
    """Words whose text differs, or whose start or end lies more than one
    frame from the reference's, position by position (a missing word
    counts)."""
    n = 0
    for row, ref_row in zip(words, ref):
        for i in range(max(len(row), len(ref_row))):
            if i >= len(row) or i >= len(ref_row):
                n += 1
                continue
            a, b = row[i], ref_row[i]
            if (a["word"] != b["word"]
                    or abs(a["start"] - b["start"]) > FRAME_S + 1e-6
                    or abs(a["end"] - b["end"]) > FRAME_S + 1e-6):
                n += 1
    return n


def test_bundles_word_timestamps_no_worse_than_jax(setup):
    """transcribe_batch(word_timestamps=True) at t=0: the JAX bundle at f32
    and at its default bf16 (f32 weights), the port's at its default bf16
    (bf16 weights); the port's words off JAX f32 at most JAX bf16's + 4."""
    params, model, audio, _ = setup

    def jax_bundle(cdt):
        b = JBundle(JConfig(), TPUConfig(compute_dtype=cdt, **KNOBS))
        b._whisper = (params, JDIMS, JTok(english=True))
        b._loaded = True
        return b

    tb = ModelBundle(torch_config=TorchConfig(compute_dtype="bfloat16",
                                              **KNOBS), device="cpu")
    tb._whisper = (model, TDIMS, ByteFallbackTokenizer(english=True))
    tb._loaded = True
    prompts = [""] * ROWS
    res = {name: b.transcribe_batch(audio, prompts, temperature=0.0,
                                    word_timestamps=True)
           for name, b in (("jax_f32", jax_bundle("float32")),
                           ("jax_bf16", jax_bundle("bfloat16")),
                           ("port_bf16", tb))}
    ref = res["jax_f32"][1]
    assert sum(map(len, ref)) >= ROWS
    jax_off = _words_off(res["jax_bf16"][1], ref)
    port_off = _words_off(res["port_bf16"][1], ref)
    assert port_off <= jax_off + WORD_SLACK, (port_off, jax_off)


@pytest.fixture(scope="module")
def teacher(setup):
    """Seeded byte words (6 a row of 1-4 letters) as generated tokens, and
    the features each configuration aligns over: JAX f32 and bf16 from the
    JAX encoder, the port's bf16 from its own."""
    params, model, _, mel = setup
    rng = np.random.default_rng(1)
    tokens = np.full((ROWS, 40), EOT, np.int64)
    lengths = np.zeros(ROWS, np.int32)
    for r in range(ROWS):
        text = " ".join("".join(chr(97 + rng.integers(26))
                                for _ in range(rng.integers(1, 5)))
                        for _ in range(6))
        ids = list(text.encode())
        tokens[r, :len(ids)] = ids
        lengths[r] = len(ids)
    jmel = jnp.asarray(mel.numpy())
    feats = {c: jw.whisper_encode(params, jmel, JDIMS, c)
             for c in (jnp.float32, jnp.bfloat16)}
    with torch.no_grad():
        port = tw.whisper_encode(model, mel, TDIMS, torch.bfloat16)
    return tokens, lengths, feats, port


def test_align_batch_word_times_no_worse_than_jax(setup, teacher):
    """align_batch as each bundle calls it (prefix [SOT, <|notimestamps|>],
    EOT): the port at bf16 moves at most JAX bf16's + 4 words off JAX
    f32's times."""
    params, model, _, _ = setup
    tokens, lengths, feats, port = teacher
    pres = [[SOT, NO_TS]] * ROWS
    words = {
        c: ja.align_batch(params, JTok(), tokens, lengths, feats[c], JDIMS,
                          prefixes=pres, eot=EOT)
        for c in (jnp.float32, jnp.bfloat16)}
    ours = ta.align_batch(model, ByteFallbackTokenizer(), tokens, lengths,
                          port, TDIMS, prefixes=pres, eot=EOT)
    ref = words[jnp.float32]
    assert sum(map(len, ref)) == 6 * ROWS
    jax_off = _words_off(words[jnp.bfloat16], ref)
    port_off = _words_off(ours, ref)
    assert port_off <= jax_off + WORD_SLACK, (port_off, jax_off)


def test_cross_attention_drift_no_worse_than_jax(setup, teacher):
    """The averaged cross-attention of one teacher batch: the port's bf16
    drift from JAX f32 at most 1.25x JAX bf16's."""
    params, model, _, _ = setup
    tokens, lengths, feats, port = teacher
    t = np.full((ROWS, 64), EOT, np.int64)
    t[:, 0], t[:, 1] = SOT, NO_TS
    for r in range(ROWS):
        t[r, 2:2 + lengths[r]] = tokens[r, :lengths[r]]
    attn = {c: np.asarray(ja.cross_attention_weights(
        params, jnp.asarray(t), feats[c], JDIMS))
        for c in (jnp.float32, jnp.bfloat16)}
    ours = ta.cross_attention_weights(model, torch.from_numpy(t), port,
                                      TDIMS).numpy()
    ref = attn[jnp.float32]
    jax_drift = float(np.abs(attn[jnp.bfloat16] - ref).mean())
    port_drift = float(np.abs(ours - ref).mean())
    assert 0 < port_drift <= DRIFT_RATIO * jax_drift, (port_drift, jax_drift)


def test_pass_runs_in_f32_over_the_stored_weights(setup, teacher):
    """The port's pass at the bundle's default is the f32 pass over its
    bf16-stored weights: a copy of the model widened to f32 gives the same
    attention bit for bit, and the output is f32."""
    import copy

    _, model, _, _ = setup
    tokens, _, _, port = teacher
    t = torch.from_numpy(np.concatenate(
        [np.full((ROWS, 2), SOT), tokens[:, :30]], axis=1))
    t[:, 1] = NO_TS
    ours = ta.cross_attention_weights(model, t, port, TDIMS)
    widened = ta.cross_attention_weights(copy.deepcopy(model).float(), t,
                                         port, TDIMS)
    assert ours.dtype == torch.float32
    assert torch.equal(ours, widened)
