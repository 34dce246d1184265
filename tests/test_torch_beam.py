"""Port beam search, language detection, native bundle checkpoints and the
safetensors reader/writer against the JAX package (f32, CPU): beam_decode
tokens identical and sum-logprobs within 1e-4 (plain, timestamped, int8
self-KV and context-full), the bundle's beam_size-vs-best_of routing, the
detected language ids, a multilingual bundle with no pinned language, an
exact save_native/load_native round trip, and safetensors files read and
written both ways."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from clearconverse_tpu.config import Config as JConfig, TPUConfig
from clearconverse_tpu.models import decoding as jdec
from clearconverse_tpu.models import whisper as jw
from clearconverse_tpu.models.tokenizer import ByteFallbackTokenizer as JTok
from clearconverse_tpu.pipeline.bundle import ModelBundle as JBundle

from clearconverse_tpu_torch.config import TorchConfig
from clearconverse_tpu_torch.models import decoding as tdec
from clearconverse_tpu_torch.models import whisper as tw
from clearconverse_tpu_torch.models.convert import whisper_from_jax_params
from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
from clearconverse_tpu_torch.pipeline.bundle import ModelBundle

KW = dict(n_mels=80, n_vocab=51864, n_audio_ctx=1500, n_audio_state=64,
          n_audio_head=2, n_audio_layer=1, n_text_ctx=448, n_text_state=64,
          n_text_head=2, n_text_layer=2)
EOT, SOT, NO_TS, TSB = 50256, 50257, 50362, 50363
TARGET = 2 * 16000
MT = 10


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _weights(kw, seed=0):
    params = jax.tree.map(np.asarray, jw.init_whisper_params(
        jax.random.PRNGKey(seed), jw.WhisperDims(**kw)))
    return params, whisper_from_jax_params(params, tw.WhisperDims(**kw), "cpu")


@pytest.fixture(scope="module")
def weights():
    return _weights(KW)


def _audio(n, t=24000, seed=0):
    return (np.random.default_rng(seed).standard_normal((n, t))
            .astype(np.float32) * 0.1)


def _beam_pair(params, model, kw, audio, prompts, max_p, **opt_kw):
    """JAX and port greedy_decode_from_audio with beam options on the same
    weights, audio and replica-tiled prompts."""
    R = opt_kw["replicas"]
    rows = [p for p in prompts for _ in range(R)]
    toks, lens = jdec.build_prompt_batch(rows, max_p, EOT)
    base = dict(max_tokens=MT, eot=EOT, beam=True, suppress_blank=True)
    base.update(opt_kw)
    ref = jdec.greedy_decode_from_audio(
        params, jnp.asarray(audio), jnp.asarray(toks), jnp.asarray(lens),
        jw.WhisperDims(**kw), jdec.DecodeOptions(**base), max_p,
        target_len=TARGET)
    ours = tdec.greedy_decode_from_audio(
        model, torch.from_numpy(audio), torch.from_numpy(toks),
        torch.from_numpy(lens), tw.WhisperDims(**kw),
        tdec.DecodeOptions(**base), max_p, target_len=TARGET)
    return {k: np.asarray(v) for k, v in ref.items()}, ours


def _assert_same_beams(ref, ours):
    np.testing.assert_array_equal(ours["tokens"].numpy(), ref["tokens"])
    np.testing.assert_array_equal(ours["lengths"].numpy(), ref["lengths"])
    np.testing.assert_allclose(ours["sum_logprob"].numpy(),
                               ref["sum_logprob"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours["no_speech_prob"].numpy(),
                               ref["no_speech_prob"], rtol=0, atol=1e-5)


CASES = {
    # replicas, suppressed ids, timestamps, self-KV width
    "beam5": dict(replicas=5, suppress_tokens=tuple(range(SOT, 51864))),
    "beam3_int8_self_kv": dict(replicas=3, self_kv_bits=8,
                               suppress_tokens=tuple(range(SOT, 51864))),
    "beam3_timestamps": dict(replicas=3, timestamps=True,
                             timestamp_begin=TSB,
                             suppress_tokens=tuple(range(SOT, TSB))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_decode_matches_jax(weights, case):
    params, model = weights
    opt_kw = dict(CASES[case])
    ts = opt_kw.get("timestamps", False)
    prompts = ([[SOT], [50360, 11, 22, SOT]] if ts
               else [[SOT, NO_TS], [50360, 11, 22, SOT, NO_TS]])
    ref, ours = _beam_pair(params, model, KW, _audio(2), prompts, 16,
                           no_speech_token=50361,
                           sot_from_end=1 if ts else 2, **opt_kw)
    _assert_same_beams(ref, ours)
    assert 1 <= ours["steps"] <= MT
    assert (ref["tokens"] != EOT).any()          # not a trivial decode
    if ts:
        assert (ref["tokens"] >= TSB).any()


def test_beam_decode_context_full_freezes_and_fills_like_jax():
    """A group whose prompt leaves 3 context slots freezes at the context
    end; its live beams fill the store at finalize (the JAX test at
    tests/test_whisper.py:251, on the port)."""
    kw = dict(KW, n_text_ctx=16, n_text_layer=1)
    params, model = _weights(kw, seed=1)
    plen = kw["n_text_ctx"] - 3
    prompt = [SOT] + [(7 * i) % 200 + 1 for i in range(plen - 1)]
    ref, ours = _beam_pair(params, model, kw, _audio(1, seed=1), [prompt],
                           plen, replicas=2, suppress_blank=False)
    _assert_same_beams(ref, ours)
    # The context budget, not max_tokens, ended every beam.
    assert (ref["lengths"] <= 3).all()


def test_beam_rejects_sampling_temperature(weights):
    _, model = weights
    opts = tdec.DecodeOptions(max_tokens=4, replicas=2, beam=True,
                              temperature=0.5)
    toks, lens = jdec.build_prompt_batch([[SOT]] * 2, 4, EOT)
    mel = torch.zeros((1, 80, 200))
    with pytest.raises(ValueError, match="temperature-0"):
        tdec.beam_decode(model, mel, torch.from_numpy(toks),
                         torch.from_numpy(lens), tw.WhisperDims(**KW), opts, 4)


# ----------------------------------------------------------------- bundle

class _FakeDecode:
    """Scripted greedy_decode_from_audio stand-in (tests/test_bundle.py):
    records (decode rows, temperature, generator, audio rows, replicas,
    beam) per call."""

    def __init__(self, script):
        self.script = script
        self.calls = []

    def __call__(self, model, audio, toks, lens, dims, opts, max_p,
                 generator=None, **kw):
        rows = int(toks.shape[0])
        assert rows == int(audio.shape[0]) * opts.replicas
        self.calls.append((rows, opts.temperature, generator,
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


def _bundle(kw=KW, english=True, seed=0, **knobs):
    params, model = _weights(kw, seed)
    knobs = dict(dict(max_decode_tokens=8, max_fallback_attempts=2,
                      compute_dtype="float32", cross_kv_bits=16), **knobs)
    tb = ModelBundle(torch_config=TorchConfig(**knobs), device="cpu")
    tb._whisper = (model, tw.WhisperDims(**kw),
                   ByteFallbackTokenizer(english=english))
    tb._loaded = True
    return params, tb


def test_beam_size_routes_beam_decode_on_greedy_rungs():
    """whisper's split (tests/test_bundle.py:430, on the port): t=0 rungs
    decode beam_size beams per row (opts.beam), t>0 retry rungs sample
    best_of replicas with a generator."""
    from unittest.mock import patch
    _, tb = _bundle(KW, beam_size=3, best_of=2, max_fallback_attempts=3)
    fake = _FakeDecode([
        {"default": {"sum_lp": -0.5}, 3: {"sum_lp": -90.0},
         4: {"sum_lp": -90.0}, 5: {"sum_lp": -90.0}},
        {"default": {"sum_lp": -0.3}},
    ])
    with patch.object(tdec, "greedy_decode_from_audio", fake):
        texts = tb.transcribe_batch(_audio(2, 8000), ["", ""],
                                    temperature=(0.0, 0.2))
    assert len(texts) == 2 and len(fake.calls) == 2
    assert fake.calls[0][3:] == (2, 3, True)
    assert fake.calls[0][0] == 6 and fake.calls[0][2] is None
    assert fake.calls[1][3:] == (1, 2, False)
    assert fake.calls[1][2] is not None


def _jax_bundle(params, kw, english=True, **knobs):
    knobs = dict(dict(max_decode_tokens=8, max_fallback_attempts=2,
                      compute_dtype="float32", cross_kv_bits=16), **knobs)
    jb = JBundle(JConfig(), TPUConfig(**knobs))
    jb._whisper = (params, jw.WhisperDims(**kw), JTok(english=english))
    jb._loaded = True
    return jb


@pytest.mark.parametrize("long", [False, True], ids=["batch", "long_batch"])
def test_bundle_beam_texts_match_jax(long):
    """transcribe_batch and transcribe_long_batch at beam_size 3, t=0:
    identical results from both packages."""
    kw = dict(KW, n_text_layer=1)
    params, tb = _bundle(kw, beam_size=3)
    jb = _jax_bundle(params, kw, beam_size=3)
    audio, prompts = _audio(2, 16000, seed=4), ["", "context"]
    if long:
        ref = jb.transcribe_long_batch(audio, prompts, temperature=0.0)
        ours = tb.transcribe_long_batch(audio, prompts, temperature=0.0)
    else:
        ref = jb.transcribe_batch(audio, prompts, temperature=0.0)
        ours = tb.transcribe_batch(audio, prompts, temperature=0.0)
    assert ours == ref


MULTI = dict(KW, n_vocab=51865, n_text_layer=1)


def test_detect_language_matches_jax():
    params, model = _weights(MULTI, seed=2)
    sp = ByteFallbackTokenizer(english=False).specials
    audio = _audio(3, 20000, seed=5)
    args = (sp.sot, sp.sot + 1, sp.translate, TARGET)
    ref = np.asarray(jdec.detect_language_from_audio(
        params, jnp.asarray(audio), jw.WhisperDims(**MULTI), *args))
    ours = tdec.detect_language_from_audio(
        model, torch.from_numpy(audio), tw.WhisperDims(**MULTI), *args)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert ((ref >= sp.sot + 1) & (ref < sp.translate)).all()


def test_multilingual_bundle_detects_like_jax():
    """language=None on a multilingual model: detection, prompts and the
    decode give the JAX bundle's texts, word timestamps included."""
    params, tb = _bundle(MULTI, english=False, seed=2, language=None)
    jb = _jax_bundle(params, MULTI, english=False, language=None)
    audio = _audio(2, 16000, seed=6)
    ref = jb.transcribe_batch(audio, ["", "x"], temperature=0.0,
                              word_timestamps=True)
    ours = tb.transcribe_batch(audio, ["", "x"], temperature=0.0,
                               word_timestamps=True)
    assert ours[0] == ref[0]
    assert [[w["word"] for w in ws] for ws in ours[1]] == \
        [[w["word"] for w in ws] for ws in ref[1]]


# ------------------------------------------------------- native checkpoints

def _full_bundle():
    from clearconverse_tpu_torch.models.ecapa import EcapaDims, init_ecapa
    from clearconverse_tpu_torch.models.pyannet import PyannetDims, init_pyannet
    from clearconverse_tpu_torch.models.resepformer import (
        SepformerDims, init_sepformer)
    _, tb = _bundle(dict(KW, n_text_layer=1))
    edims = EcapaDims(n_mels=24, channels=32, mfa_channels=48,
                      attention_channels=16, embedding_dim=16,
                      res2net_scale=4)
    pdims = PyannetDims(conv_channels=20, lstm_hidden=16, lstm_layers=1,
                        linear_dims=(16,))
    sdims = SepformerDims(enc_channels=16, d_model=16, n_heads=2,
                          chunk_size=20, n_repeats=1, n_intra_layers=1,
                          n_inter_layers=1)
    tb._ecapa, tb._ecapa_dims = init_ecapa(edims, 1, "cpu"), edims
    tb._pyannet, tb._pyannet_dims = init_pyannet(pdims, 3, "cpu"), pdims
    tb._sepformer = init_sepformer(sdims, 0, "cpu")
    return tb


def _flat(tree, prefix=""):
    if isinstance(tree, torch.nn.Module):
        return {prefix + k: v for k, v in tree.state_dict().items()}
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix: tree}


@pytest.mark.parametrize("with_meta", [True, False], ids=["meta", "pre_meta"])
def test_save_native_load_native_round_trip(tmp_path, with_meta):
    """Every weight of every family back exactly, dims from the meta block
    (or, without one, from the name table and the shapes)."""
    src = _full_bundle()
    path = str(tmp_path / "bundle.pt")
    src.save_native(path)
    if not with_meta:
        payload = torch.load(path, weights_only=True)
        assert set(payload["meta"]) == {"whisper_dims", "ecapa_dims",
                                        "pyannet_dims", "sepformer_dims"}
        del payload["meta"]
        torch.save(payload, path)
    dst = ModelBundle(torch_config=src.torch_config, device="cpu")
    dst.load_native(path)
    assert dst.load_source == {"whisper": "payload", "ecapa": "payload",
                               "pyannet": "payload", "sepformer": "payload",
                               "tokenizer": "ByteFallbackTokenizer"}
    for get in (lambda b: b._whisper[0], lambda b: b._ecapa,
                lambda b: b._pyannet, lambda b: b._sepformer):
        a, b = _flat(get(src)), _flat(get(dst))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    if with_meta:
        assert dst._whisper[1] == src._whisper[1]
        assert (dst._ecapa_dims, dst._pyannet_dims, dst._sepformer.dims) == \
            (src._ecapa_dims, src._pyannet_dims, src._sepformer.dims)
        audio = _audio(1, 16000, seed=7)
        assert dst.transcribe_batch(audio, [""]) == \
            src.transcribe_batch(audio, [""])
    else:
        # No weight shape holds a head count: those come from the table.
        table = tw.model_dims(src.config.whisper_model_size)
        assert dst._whisper[1] == dataclasses.replace(
            src._whisper[1], n_audio_head=table.n_audio_head,
            n_text_head=table.n_text_head)


# ------------------------------------------------------------ safetensors

def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    """A whisper-ft overlay written by safetensors.numpy reads back through
    the port's reader, and the port's file through safetensors.numpy, to
    identical arrays; bf16 through safetensors.torch both ways."""
    from safetensors.numpy import load_file as np_load, save_file as np_save
    from safetensors.torch import load_file as pt_load, save_file as pt_save
    from clearconverse_tpu_torch.models.convert import load_torch_state_dict
    from clearconverse_tpu_torch.train.checkpoint import (
        whisper_to_openai_state_dict)
    from clearconverse_tpu_torch.utils import safetensors as st

    rng = np.random.default_rng(0)
    _, model = _weights(dict(KW, n_text_layer=1))
    arrays = dict(whisper_to_openai_state_dict(model))
    arrays.update({
        "f16": rng.standard_normal((3, 5)).astype(np.float16),
        "i64": rng.integers(-9, 9, (4,)).astype(np.int64),
        "i32": rng.integers(-9, 9, (2, 3)).astype(np.int32),
        "i8": rng.integers(-9, 9, (7,)).astype(np.int8),
        "scalar": np.array(2.5, np.float32)})
    ft = tmp_path / "models" / "whisper-ft"
    ft.mkdir(parents=True)
    np_save(arrays, str(ft / "model.safetensors"), metadata={"format": "np"})
    ours = st.load_file(str(ft / "model.safetensors"))
    mine = str(tmp_path / "ours.safetensors")
    st.save_file(arrays, mine, metadata={"format": "pt"})
    theirs = np_load(mine)
    for got in (ours, theirs):
        assert got.keys() == arrays.keys()
        for k, v in arrays.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v)
    # The loader reads the overlay through the port's reader (f16 → f32).
    loaded = load_torch_state_dict(str(ft / "model.safetensors"))
    np.testing.assert_array_equal(loaded["f16"], arrays["f16"].astype(np.float32))

    bf = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)).bfloat16()
    pt_save({"w": bf}, str(tmp_path / "bf_pkg.safetensors"))
    np.testing.assert_array_equal(
        st.load_file(str(tmp_path / "bf_pkg.safetensors"))["w"],
        bf.float().numpy())
    st.save_file({"w": bf}, str(tmp_path / "bf_port.safetensors"))
    assert torch.equal(pt_load(str(tmp_path / "bf_port.safetensors"))["w"], bf)


def test_safetensors_reader_rejects_a_truncated_file(tmp_path):
    from clearconverse_tpu_torch.utils import safetensors as st
    path = str(tmp_path / "x.safetensors")
    st.save_file({"a": np.arange(6, dtype=np.float32)}, path)
    with open(path, "rb") as fh:
        raw = fh.read()
    with open(path, "wb") as fh:
        fh.write(raw[:-4])
    with pytest.raises(ValueError, match="outside the data"):
        st.load_file(path)
