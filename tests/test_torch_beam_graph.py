"""Beam search as the port now runs it: one step function (``_beam_step``)
over device state, the finished-sequence store written by a fixed-shape
scatter with a drop slot (``_beam_store``), run on the CPU one step at a
time and, as a CUDA graph captures it, in chunks of ``decode_graph.K``
steps with overrun.

Against the JAX package's jitted ``beam_decode`` at a tiny config (f32,
t=0, CPU): identical tokens and lengths, sum-logprob within 1e-4 and
no-speech probability within 1e-5 (as tests/test_torch_beam.py), on models
whose EOT logit carries a constant bias, so finished sequences fill the
store mid-loop or after one step. Then the K-step chunks against the
step-by-step loop, bit for bit, with no host read inside a chunk; and the
drop-slot store against the ``torch.nonzero`` store it replaced."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from clearconverse_tpu.models import decoding as jdec
from clearconverse_tpu.models import whisper as jw

from clearconverse_tpu_torch.audio.mel import log_mel_auto, pad_or_trim
from clearconverse_tpu_torch.models import decode_graph
from clearconverse_tpu_torch.models import decoding as tdec
from clearconverse_tpu_torch.models import whisper as tw
from clearconverse_tpu_torch.models.convert import whisper_from_jax_params

KW = dict(n_mels=80, n_vocab=51864, n_audio_ctx=1500, n_audio_state=64,
          n_audio_head=2, n_audio_layer=1, n_text_ctx=448, n_text_state=64,
          n_text_head=2, n_text_layer=2)
EOT, SOT, NO_SPEECH, NO_TS, TSB = 50256, 50257, 50361, 50362, 50363
TARGET = 2 * 16000
MAX_P = 16
K = decode_graph.K


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _params(seed=0):
    return jax.tree.map(np.asarray, jw.init_whisper_params(
        jax.random.PRNGKey(seed), jw.WhisperDims(**KW)))


def _eot_biased(params, beta: float):
    """A copy of ``params`` whose EOT logit is ``beta`` above what it was
    against every other token: channel 0 of the final layer norm becomes a
    constant 1 (gain 0, bias 1), and only EOT's embedding reads it."""
    p = copy.deepcopy(params)
    dec = p["decoder"]
    dec["ln"]["g"][0] = 0.0
    dec["ln"]["b"][0] = 1.0
    dec["tok"][:, 0] = 0.0
    dec["tok"][EOT, 0] = beta
    return p


@pytest.fixture(scope="module")
def params():
    return _params()


def _model(params):
    return whisper_from_jax_params(params, tw.WhisperDims(**KW), "cpu")


def _audio(n, seed=0):
    return (np.random.default_rng(seed).standard_normal((n, 24000))
            .astype(np.float32) * 0.1)


def _rows(R: int, timestamps: bool):
    """Two groups of R beams: a bare prompt and one with context."""
    tail = [SOT] if timestamps else [SOT, NO_TS]
    prompts = [tail, [50360, 11, 22] + tail]
    return jdec.build_prompt_batch(
        [p for p in prompts for _ in range(R)], MAX_P, EOT)


def _opt_kw(case: dict) -> dict:
    ts = case.get("timestamps", False)
    suppress = tuple(range(SOT, TSB if ts else 51864))
    if case.get("suppress_eot"):
        suppress = (EOT,) + suppress
    kw = dict(max_tokens=case.get("max_tokens", 20), eot=EOT, beam=True,
              replicas=case["replicas"], no_speech_token=NO_SPEECH,
              sot_from_end=1 if ts else 2, suppress_tokens=suppress)
    if ts:
        kw.update(timestamps=True, timestamp_begin=TSB)
    for name in ("cross_kv_bits", "self_kv_bits"):
        if name in case:
            kw[name] = case[name]
    return kw


JAX_CASES = {
    # The store fills mid-loop: group 0 first, group 1 steps later.
    "eot_bias_3.85_beam3": dict(replicas=3, beta=3.85),
    "eot_bias_3.95_beam4_cross_kv8_max_tokens_13": dict(
        replicas=4, beta=3.95, cross_kv_bits=8, max_tokens=13),
    # Every group full after one step.
    "eot_bias_40_beam3": dict(replicas=3, beta=40.0),
    "beam2_self_kv8_cross_kv4_timestamps": dict(
        replicas=2, self_kv_bits=8, cross_kv_bits=4, timestamps=True,
        max_tokens=11),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_beam_step_decode_matches_jax(params, case):
    case = JAX_CASES[case]
    p = _eot_biased(params, case["beta"]) if "beta" in case else params
    kw = _opt_kw(case)
    toks, lens = _rows(case["replicas"], kw.get("timestamps", False))
    audio = _audio(2, seed=5)
    ref = jdec.greedy_decode_from_audio(
        p, jnp.asarray(audio), jnp.asarray(toks), jnp.asarray(lens),
        jw.WhisperDims(**KW), jdec.DecodeOptions(**kw), MAX_P,
        target_len=TARGET)
    ours = tdec.greedy_decode_from_audio(
        _model(p), torch.from_numpy(audio), torch.from_numpy(toks),
        torch.from_numpy(lens), tw.WhisperDims(**KW),
        tdec.DecodeOptions(**kw), MAX_P, target_len=TARGET)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    np.testing.assert_array_equal(ours["tokens"].numpy(), ref["tokens"])
    np.testing.assert_array_equal(ours["lengths"].numpy(), ref["lengths"])
    np.testing.assert_allclose(ours["sum_logprob"].numpy(),
                               ref["sum_logprob"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours["no_speech_prob"].numpy(),
                               ref["no_speech_prob"], rtol=0, atol=1e-5)
    assert 1 <= ours["steps"] <= kw["max_tokens"]
    if case.get("beta", 0) > 10:
        assert ours["steps"] == 2                   # full after one step
    elif "beta" in case:
        assert ours["steps"] < kw["max_tokens"]     # the store ended it


_HOST_READS = ("__bool__", "__int__", "__float__", "__index__", "item",
               "tolist", "numpy")


def _no_host_reads(monkeypatch):
    """Make every read of a tensor's value into Python raise, as a CUDA
    graph capture does."""
    def refuse(*a, **k):
        raise AssertionError("host read inside a beam step")
    for name in _HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)


def _started(model, opts, case):
    """Prefill and step 0 of a beam decode, as beam_decode runs them."""
    dims = tw.WhisperDims(**KW)
    audio = torch.from_numpy(_audio(2, seed=6))
    mel = log_mel_auto(pad_or_trim(audio, TARGET), KW["n_mels"])
    toks, lens = (torch.from_numpy(x).long()
                  for x in _rows(case["replicas"], opts.timestamps))
    B, P = toks.shape
    cross_kv, self_kv, logits, pad, max_len = tdec._prefill(
        model, mel, toks, lens, dims, opts, MAX_P, spare=K)
    c = tdec._loop_inputs(model, dims, opts, cross_kv, lens, pad, P,
                          max_len + K, logits.shape[-1], None)
    s = tdec._new_beam_state(B, opts.replicas, opts.max_tokens, self_kv,
                             mel.device)
    tdec._start_beam(s, c, logits[:, -1, :])
    return s, c, (mel, toks, lens)


CHUNK_CASES = {
    "ends_mid_chunk": dict(replicas=3, beta=3.85),
    "full_after_one_step": dict(replicas=3, beta=40.0),
    "max_tokens_reached": dict(replicas=3, suppress_eot=True,
                               max_tokens=13),
    # max_tokens ends the loop one step before group 0's store fills
    # (at step 12 with more tokens), so the first overrun step finds an
    # EOT that a live step would store.
    "max_tokens_reached_store_open": dict(replicas=3, beta=3.85,
                                          max_tokens=12),
    "max_tokens_reached_self_kv8_timestamps": dict(
        replicas=2, suppress_eot=True, max_tokens=21, self_kv_bits=8,
        cross_kv_bits=4, timestamps=True),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_beam_chunks_with_overrun_give_the_step_loop_result(
        params, case, monkeypatch):
    """Chunks of K beam steps, as one graph replay runs them, past the
    loop's end (up to K - 1 steps past max_tokens, and whole chunks after
    every group is full): every field of the loop state but the step, the
    cache and the store's drop slot, the finalized store and the step
    count equal the step-by-step loop's bit for bit; no chunk reads a
    value back to the host; the stop flag is read at most
    ceil(steps / K) + 1 times."""
    name = case
    case = CHUNK_CASES[case]
    p = _eot_biased(params, case["beta"]) if "beta" in case else params
    model = _model(p)
    opts = tdec.DecodeOptions(**_opt_kw(case))
    mt = opts.max_tokens
    with torch.inference_mode():
        ref, c, (mel, toks, lens) = _started(model, opts, case)
        ref_steps = tdec._loop_eager(ref, c, tdec._beam_step)
        s, c, _ = _started(model, opts, case)
        n_chunks = -(-(mt - 1) // K)

        def launch(i):
            with monkeypatch.context() as m:
                _no_host_reads(m)
                tdec._beam_steps(s, c)

        steps, launched, reads = decode_graph.drive(
            launch, s.ctl, n_chunks, decode_graph.StopFlags(
                torch.device("cpu")))
        public = tdec.beam_decode(model, mel, toks, lens,
                                  tw.WhisperDims(**KW), opts, MAX_P)
        fin_ref, fin = tdec._finish_beam(ref, opts), tdec._finish_beam(s, opts)

    assert steps == ref_steps and public["steps"] == steps + 1
    for field in ("slp", "prev", "prev2", "last_ts", "fin_count"):
        assert torch.equal(getattr(s, field), getattr(ref, field)), field
    R = opts.replicas                 # the store's drop slot R is not read
    assert torch.equal(s.fin_tokens[:, :R], ref.fin_tokens[:, :R])
    assert torch.equal(s.fin_scores[:, :R], ref.fin_scores[:, :R])
    assert torch.equal(s.tokens[:, :mt], ref.tokens[:, :mt])
    assert (s.tokens[:, mt:] == EOT).all()          # overrun wrote nothing
    for a, b in zip(fin, fin_ref):
        assert torch.equal(a, b)
    assert torch.equal(public["tokens"], fin[0])
    assert torch.equal(public["sum_logprob"], fin[1])
    assert int(s.step) == 1 + launched * K
    assert reads <= -(-(steps + 1) // K) + 1
    if name == "ends_mid_chunk":
        assert steps % K and steps < mt - 1
    elif name == "full_after_one_step":
        assert steps == 1 and launched == 2         # 15 steps of overrun
        assert (s.fin_count == opts.replicas).all()
    else:
        assert steps == mt - 1 and launched == n_chunks
        assert launched * K > mt - 1                # some steps overran
    if name == "max_tokens_reached_store_open":
        assert (ref.fin_count > 0).any() and (ref.fin_count < R).any()


def _nonzero_store(fin_tokens, fin_scores, rows, ord_sc, ord_idx, slots,
                   keep):
    """The store as the eager loop wrote it before the graph route: the
    kept entries found with ``torch.nonzero`` (a host read)."""
    G, R, mt = fin_tokens.shape
    hist = rows.reshape(G, R, -1)[:, :, :mt].gather(
        1, ord_idx[:, :, None].expand(G, R, mt))
    gi, ri = torch.nonzero(keep, as_tuple=True)
    fin_tokens[gi, slots[gi, ri]] = hist[gi, ri]
    fin_scores[gi, slots[gi, ri]] = ord_sc[gi, ri]


@pytest.mark.parametrize("seed", range(4))
def test_drop_slot_store_equals_the_nonzero_store(seed):
    """Random groups, histories, scores, per-group insertion counts and
    keep masks (kept slots below R and distinct within a group, as the
    beam step makes them): slots 0..R-1 of the drop-slot store equal the
    nonzero store, and slot R never reaches a result."""
    rng = np.random.default_rng(seed)
    G, R, mt = int(rng.integers(1, 5)), int(rng.integers(2, 6)), 9
    B = G * R
    tokens = torch.from_numpy(rng.integers(0, 1000, (B, mt + K)))
    ord_idx = torch.from_numpy(np.stack(
        [rng.permutation(R) for _ in range(G)]))
    ord_sc = torch.from_numpy(-rng.random((G, R)).astype(np.float32))
    count = torch.from_numpy(rng.integers(0, R + 1, G))
    valid = torch.from_numpy(rng.random((G, R)) < 0.6)
    # Group 0 keeps one entry and drops one past its capacity.
    count[0], valid[0, :2] = R - 1, True
    slots = count[:, None] + torch.cumsum(valid.long(), 1) - 1
    keep = valid & (slots < R)
    state = tdec._new_beam_state(B, R, mt, [], torch.device("cpu"))
    state.tokens.copy_(tokens)
    state.fin_tokens.fill_(-7)
    state.fin_scores.fill_(float("-inf"))
    ref_tokens = state.fin_tokens[:, :R].clone()
    ref_scores = state.fin_scores[:, :R].clone()
    _nonzero_store(ref_tokens, ref_scores, tokens, ord_sc, ord_idx, slots,
                   keep)
    tdec._beam_store(state, ord_sc, ord_idx, slots, keep)
    assert torch.equal(state.fin_tokens[:, :R], ref_tokens)
    assert torch.equal(state.fin_scores[:, :R], ref_scores)


def test_warm_up_reaches_beam_search_at_every_row_bucket(monkeypatch):
    """beam_size 3 under a temperature ladder that starts at 0: every
    warm-up drive's first rung is beam search (3 beams a row, the mel
    carrying the unique rows), and the first drive has the most rows, so on
    the card it sizes the decode graphs' arena for every later key."""
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine
    from clearconverse_tpu_torch.serve.warmup import warm_decode_shapes

    dims = tw.WhisperDims(n_audio_state=64, n_audio_head=2, n_audio_layer=1,
                          n_text_state=64, n_text_head=2, n_text_layer=1)
    bundle = ModelBundle(
        Config(transcription_batch_size=2, temperature=(0.0, 0.2)),
        TorchConfig(max_decode_tokens=4, compute_dtype="float32",
                    duration_buckets=(5.0,), beam_size=3), device="cpu")
    bundle._whisper = (init_whisper(dims, 0, "cpu"), dims,
                       ByteFallbackTokenizer(english=True))
    bundle._loaded = True
    eng = TranscriptionEngine(bundle.config, bundle.torch_config,
                              models=bundle)
    calls = []
    orig = tdec.beam_decode

    def spy(model, mel, prompt_tokens, *a, **kw):
        calls.append((int(prompt_tokens.shape[0]), int(mel.shape[0])))
        return orig(model, mel, prompt_tokens, *a, **kw)

    monkeypatch.setattr(tdec, "beam_decode", spy)
    firsts = []

    def drive(label, fn):
        n = len(calls)
        fn()
        firsts.append((label, calls[n] if len(calls) > n else None))

    assert warm_decode_shapes(eng, drive) is None      # no card here
    assert len(firsts) == 14
    assert all(first is not None for _, first in firsts), firsts
    assert all(rows == 3 * mel_rows for _, (rows, mel_rows) in firsts)
    assert firsts[0][1] == (6, 2)
    assert {first for _, first in firsts} == {(6, 2), (3, 1)}
