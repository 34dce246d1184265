"""The scripted-decode contracts of tests/test_bundle.py, held on the
port's ModelBundle.

The same tiny Whisper (the JAX package's PRNGKey(0) weights, converted),
the same audio and the same scripts: the no-speech gate, the row-sparse
fallback retry, token-tuple prompts, ``reset_context``, best_of on the first
rung of a scalar temperature, the ranker, beam routing, a scalar t=0, a new
seed per sampling call, prompt and alignment row buckets, the long-batch
contract and bucketed windows. The port's stand-in decoder takes the
port's signature; the port reseeds one ``torch.Generator`` per sampling
call, so the seed a call drew stands in for the JAX package's key.
"""

import dataclasses
from unittest.mock import patch

import numpy as np
import pytest
import torch

import jax

from clearconverse_tpu.models.whisper import WhisperDims as JDims
from clearconverse_tpu.models.whisper import init_whisper_params

from clearconverse_tpu_torch.config import Config, TorchConfig
from clearconverse_tpu_torch.models import alignment as amod
from clearconverse_tpu_torch.models import decoding as dec
from clearconverse_tpu_torch.models.convert import whisper_from_jax_params
from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
from clearconverse_tpu_torch.models.whisper import WhisperDims
from clearconverse_tpu_torch.pipeline.bundle import ModelBundle

KW = dict(n_mels=80, n_vocab=51864, n_audio_ctx=1500, n_audio_state=64,
          n_audio_head=2, n_audio_layer=1, n_text_ctx=448, n_text_state=64,
          n_text_head=2, n_text_layer=1)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bundle():
    torch.set_num_threads(1)
    tc = TorchConfig(max_decode_tokens=8, max_fallback_attempts=2,
                     compute_dtype="float32")
    b = ModelBundle(Config(), tc, device="cpu")
    params = init_whisper_params(jax.random.PRNGKey(0), JDims(**KW))
    dims = WhisperDims(**KW)
    b._whisper = (whisper_from_jax_params(params, dims, "cpu"), dims,
                  ByteFallbackTokenizer(english=True))
    b._loaded = True
    return b


@pytest.fixture
def knobs(bundle):
    """Set TorchConfig fields for one test; restored after it."""
    old = bundle.torch_config

    def set_(**kw):
        bundle.torch_config = dataclasses.replace(old, **kw)
    yield set_
    bundle.torch_config = old


class _FakeDecode:
    """Scripted greedy_decode_from_audio stand-in (tests/test_bundle.py's),
    recording each call's (decode rows, temperature, seed, audio rows,
    replicas, beam). ``audio`` carries unique rows; ``toks`` and the
    outputs carry audio rows × opts.replicas."""

    def __init__(self, script):
        self.script = script
        self.calls = []

    def __call__(self, model, audio, toks, lens, dims, opts, max_p,
                 generator=None, **kw):
        rows = int(toks.shape[0])
        assert rows == int(audio.shape[0]) * opts.replicas
        seed = None if generator is None else generator.initial_seed()
        self.calls.append((rows, opts.temperature, seed,
                           int(audio.shape[0]), opts.replicas, opts.beam))
        spec = self.script[min(len(self.calls) - 1, len(self.script) - 1)]
        tokens = np.full((rows, opts.max_tokens), opts.eot, np.int32)
        lengths = np.zeros((rows,), np.int32)
        sum_lp = np.zeros((rows,), np.float32)
        nsp = np.zeros((rows,), np.float32)
        for i in range(rows):
            row = spec.get(i, spec.get("default", {}))
            n = row.get("n_tokens", 3)
            tokens[i, :n] = row.get("token", 64 + i)
            lengths[i] = n
            sum_lp[i] = row.get("sum_lp", -0.5)
            nsp[i] = row.get("nsp", 0.0)
        return {"tokens": torch.from_numpy(tokens),
                "lengths": torch.from_numpy(lengths),
                "sum_logprob": torch.from_numpy(sum_lp),
                "no_speech_prob": torch.from_numpy(nsp)}


def _noise(rng, rows, n):
    return rng.standard_normal((rows, n)).astype(np.float32) * 0.1


def test_transcribe_long_batch_contract(bundle, rng):
    """(text, advance, reset_context, ctx_tokens) per row, 1 <= advance <=
    window seconds, no reset at a greedy scalar temperature, and the kept
    ids decode to the text."""
    sp = bundle._whisper[2].specials
    audio = _noise(rng, 2, 12 * 16000)
    lens = np.asarray([12 * 16000, 6 * 16000])
    out = bundle.transcribe_long_batch(audio, ["", "ctx"], lens)
    assert len(out) == 2
    for (text, advance, reset, ctx), win in zip(out, (12.0, 6.0)):
        assert isinstance(text, str)
        assert 1.0 <= advance <= win + 1e-6
        assert reset is False
        assert isinstance(ctx, list) and all(isinstance(t, int) for t in ctx)
        assert bundle._whisper[2].decode(
            [t for t in ctx if t < sp.eot]) == text


def test_no_speech_gate_emits_empty_text(bundle, rng):
    """A silent row (no_speech_prob > 0.6, avg logprob <= -1) gives empty
    text and is not retried, even under a fallback schedule."""
    fake = _FakeDecode([{0: {"nsp": 0.95, "sum_lp": -40.0},
                         1: {"nsp": 0.1, "sum_lp": -0.5}}])
    with patch.object(dec, "greedy_decode_from_audio", fake):
        texts = bundle.transcribe_batch(_noise(rng, 2, 8000), ["", ""],
                                        temperature=(0.0, 0.2))
    assert texts[0] == "" and texts[1] != ""
    assert len(fake.calls) == 1


def test_row_sparse_fallback_retry(bundle, rng, knobs):
    """One degenerate row of 8 retries alone (1 row x best_of), not the
    whole batch."""
    fake = _FakeDecode([{"default": {"sum_lp": -0.5}, 5: {"sum_lp": -90.0}},
                        {"default": {"sum_lp": -0.3}}])
    knobs(best_of=2, max_fallback_attempts=3)
    with patch.object(dec, "greedy_decode_from_audio", fake):
        texts = bundle.transcribe_batch(_noise(rng, 8, 8000), [""] * 8,
                                        temperature=(0.0, 0.2, 0.4))
    assert len(texts) == 8 and all(isinstance(t, str) for t in texts)
    assert len(fake.calls) == 2
    assert fake.calls[0][0] == 8
    assert fake.calls[1][0] == 2
    assert fake.calls[1][3:5] == (1, 2)
    assert fake.calls[1][1] > 0
    assert fake.calls[1][2] is not None


def test_prompt_batch_token_tuple_form(bundle):
    """(init_text, token_ids) prompts: [sot_prev] + (encode(" " + init) ++
    ids)[-ctx_keep:] + the SOT tail, ids passed through verbatim."""
    _, dims, tok = bundle._whisper
    sp = tok.specials
    ids = [11, 22, sp.timestamp_begin + 5, 33]
    toks, lens, _, _ = bundle._prompt_batch(
        [("hi", ids), ("", ids), ("hi", []), ""], tok, dims, timestamps=True)
    enc = tok.encode(" hi")
    rows = [toks[i, -int(lens[i]):].tolist() for i in range(4)]
    assert rows[0] == [sp.sot_prev] + enc + ids + [sp.sot]
    assert rows[1] == [sp.sot_prev] + ids + [sp.sot]
    assert rows[2] == [sp.sot_prev] + enc + [sp.sot]
    assert rows[3] == [sp.sot]
    long_ids = list(range(1000, 1000 + dims.n_text_ctx))
    toks2, lens2, _, _ = bundle._prompt_batch(
        [("", long_ids)], tok, dims, timestamps=True)
    keep = dims.n_text_ctx // 2 - 1
    assert toks2[0, -int(lens2[0]):].tolist() == \
        [sp.sot_prev] + long_ids[-keep:] + [sp.sot]


def test_long_batch_reset_context_semantics(bundle, rng, knobs):
    """reset_context is True after a kept result from a rung above 0.5 or
    with condition_on_previous_text off; never for a skipped window."""
    audio = _noise(rng, 1, 12 * 16000)
    lens = np.asarray([12 * 16000])
    knobs(max_fallback_attempts=3)
    for ladder, reset in (((0.0, 0.7), True), ((0.0, 0.2), False)):
        fake = _FakeDecode([{"default": {"sum_lp": -90.0}},
                            {"default": {"sum_lp": -0.3}}])
        with patch.object(dec, "greedy_decode_from_audio", fake):
            out = bundle.transcribe_long_batch(audio, [""], lens,
                                               temperature=ladder)
        assert len(fake.calls) == 2 and out[0][2] is reset
    fake = _FakeDecode([{"default": {"nsp": 0.95, "sum_lp": -40.0}}])
    with patch.object(dec, "greedy_decode_from_audio", fake):
        out = bundle.transcribe_long_batch(audio, [""], lens,
                                           temperature=0.7)
    assert out[0][0] == "" and out[0][2] is False
    fake = _FakeDecode([{"default": {"sum_lp": -0.3}}])
    old_cfg = bundle.config
    bundle.config = dataclasses.replace(old_cfg,
                                        condition_on_previous_text=False)
    try:
        with patch.object(dec, "greedy_decode_from_audio", fake):
            out = bundle.transcribe_long_batch(audio, [""], lens,
                                               temperature=0.0)
    finally:
        bundle.config = old_cfg
    assert out[0][2] is True


def test_first_rung_best_of_at_scalar_temperature(bundle, rng, knobs):
    """A scalar t=0.1 decodes best_of sampled replicas a row on its only
    rung and never retries."""
    fake = _FakeDecode([{"default": {"sum_lp": -90.0}}])
    knobs(best_of=5, max_fallback_attempts=3)
    with patch.object(dec, "greedy_decode_from_audio", fake):
        texts = bundle.transcribe_batch(_noise(rng, 3, 8000), [""] * 3,
                                        temperature=0.1)
    assert len(texts) == 3
    assert len(fake.calls) == 1
    assert fake.calls[0][0] == 20
    assert fake.calls[0][3:5] == (4, 5)
    assert fake.calls[0][5] is False
    assert fake.calls[0][1] == 0.1
    assert fake.calls[0][2] is not None


def test_best_of_keeps_max_ranker_score_replica(bundle, rng, knobs):
    """The kept replica has the largest sum_logprob / length."""
    fake = _FakeDecode([{0: {"sum_lp": -4.0, "n_tokens": 2, "token": 70},
                         1: {"sum_lp": -3.0, "n_tokens": 1, "token": 71}}])
    knobs(best_of=2)
    with patch.object(dec, "greedy_decode_from_audio", fake):
        texts = bundle.transcribe_batch(_noise(rng, 1, 8000), [""],
                                        temperature=0.1)
    assert texts[0] == bundle._whisper[2].decode([70, 70])


def test_beam_size_routes_beam_decode_on_greedy_rungs(bundle, rng, knobs):
    """t=0 rungs decode beam_size beams a row; retry rungs sample
    best_of replicas of the flagged row only."""
    fake = _FakeDecode([
        {"default": {"sum_lp": -0.5}, 3: {"sum_lp": -90.0},
         4: {"sum_lp": -90.0}, 5: {"sum_lp": -90.0}},
        {"default": {"sum_lp": -0.3}}])
    knobs(beam_size=3, best_of=2, max_fallback_attempts=3)
    with patch.object(dec, "greedy_decode_from_audio", fake):
        texts = bundle.transcribe_batch(_noise(rng, 2, 8000), ["", ""],
                                        temperature=(0.0, 0.2))
    assert len(texts) == 2
    assert len(fake.calls) == 2
    assert fake.calls[0][3:] == (2, 3, True)
    assert fake.calls[0][0] == 6 and fake.calls[0][2] is None
    assert fake.calls[1][3:] == (1, 2, False)
    assert fake.calls[1][2] is not None


def test_scalar_zero_temperature_single_greedy_decode(bundle, rng):
    """A scalar t=0 decodes each row once, without a generator, and never
    retries."""
    fake = _FakeDecode([{"default": {"sum_lp": -90.0}}])
    with patch.object(dec, "greedy_decode_from_audio", fake):
        bundle.transcribe_batch(_noise(rng, 2, 8000), ["", ""],
                                temperature=0.0)
    assert len(fake.calls) == 1
    assert fake.calls[0][0] == 2
    assert fake.calls[0][4] == 1
    assert fake.calls[0][2] is None


def test_fallback_seed_differs_per_call(bundle, rng):
    """Each sampling call draws from a new seed."""
    fake = _FakeDecode([{"default": {"sum_lp": -0.5}}])
    audio = _noise(rng, 1, 8000)
    with patch.object(dec, "greedy_decode_from_audio", fake):
        bundle.transcribe_batch(audio, [""], temperature=0.4)
        bundle.transcribe_batch(audio, [""], temperature=0.4)
    seeds = [c[2] for c in fake.calls]
    assert all(s is not None for s in seeds)
    assert seeds[0] != seeds[1]


def test_prompt_length_bucketing(bundle, rng):
    """Prompt lengths map to the static set {4, 16, 64, 256}."""
    seen = []
    orig = dec.greedy_decode_from_audio

    def spy(model, audio, toks, lens, dims, opts, max_p, *a, **kw):
        seen.append(max_p)
        return orig(model, audio, toks, lens, dims, opts, max_p, *a, **kw)

    audio = _noise(rng, 1, 8000)
    with patch.object(dec, "greedy_decode_from_audio", side_effect=spy):
        bundle.transcribe_batch(audio, ["hi"])
        bundle.transcribe_batch(audio, ["a slightly longer prompt here ok"])
    assert set(seen) <= {4, 16, 64, 256}


def test_word_timestamps_use_decode_row_bucket(bundle, rng):
    """The alignment pass pads to the decode's power-of-two row bucket; a
    pad row aligns nothing."""
    seen = []
    orig = amod.align_batch

    def spy(model, tok, tokens, lengths, feats, dims, **kw):
        seen.append((tokens.shape[0], feats.shape[0], list(lengths)))
        return orig(model, tok, tokens, lengths, feats, dims, **kw)

    with patch.object(amod, "align_batch", side_effect=spy):
        texts, words = bundle.transcribe_batch(
            _noise(rng, 3, 8000), ["", "", ""], temperature=0.0,
            word_timestamps=True)
    assert len(texts) == 3 and len(words) == 3
    (tok_rows, feat_rows, lens), = seen
    assert tok_rows == 4 and feat_rows == 4
    assert lens[3] == 0


def test_bucketed_window_mode(bundle, rng, knobs):
    """pad_to_full_window=False encodes at the bucket's length."""
    knobs(pad_to_full_window=False)
    texts = bundle.transcribe_batch(_noise(rng, 2, 3 * 16000), ["", ""])
    assert len(texts) == 2
