"""The decode program as the port now runs it (one step function over device
state, a device-tensor cache index, the suppression mask built once)
against the JAX package's jitted ``greedy_decode`` at a tiny config (f32,
t=0, CPU): identical tokens and lengths, sum_logprob and no_speech_prob
within 1e-5 (as tests/test_torch_decoding.py), over timestamps, int8
self-KV, int8 and int4 cross-KV, a prompt that reaches the text context and
max_tokens that are not a multiple of the graph's K. Then the K-step
chunking that a CUDA graph captures, run eagerly here with its overrun,
against the step-by-step loop."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from clearconverse_tpu.models import decoding as jdec
from clearconverse_tpu.models import whisper as jw

from clearconverse_tpu_torch.models import decode_graph
from clearconverse_tpu_torch.models import decoding as tdec
from clearconverse_tpu_torch.models import whisper as tw
from clearconverse_tpu_torch.models.convert import whisper_from_jax_params

torch.set_num_threads(1)

KW = dict(n_mels=80, n_vocab=51864, n_audio_ctx=1500, n_audio_state=64,
          n_audio_head=2, n_audio_layer=1, n_text_ctx=448, n_text_state=64,
          n_text_head=2, n_text_layer=2)
EOT, SOT, NO_SPEECH, NO_TS, TSB = 50256, 50257, 50361, 50362, 50363
TARGET = 2 * 16000          # 2 s windows keep the CPU encoder small


@pytest.fixture(autouse=True)
def _no_tf32():
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


def _prompts(n, timestamps: bool):
    """Left-padded prompt rows of three lengths, ending in SOT (and
    no-timestamps unless ``timestamps``)."""
    tail = [SOT] if timestamps else [SOT, NO_TS]
    lists = [[50360, 11, 22] + tail, tail, [50360, 7] + tail]
    return jdec.build_prompt_batch([lists[i % 3] for i in range(n)], 16, EOT)


def _opt_kw(case: dict) -> dict:
    ts = case.get("timestamps", False)
    kw = dict(max_tokens=case.get("max_tokens", 10), eot=EOT,
              no_speech_token=NO_SPEECH, sot_from_end=1 if ts else 2,
              suppress_tokens=tuple(range(SOT, TSB if ts else 51864)))
    if ts:
        kw.update(timestamps=True, timestamp_begin=TSB)
    for name in ("cross_kv_bits", "self_kv_bits"):
        if name in case:
            kw[name] = case[name]
    return kw


def _assert_same(ours, ref, mt):
    """Identical tokens, lengths and integer columns of the packed array;
    sum_logprob and no_speech_prob within 1e-5 (JAX and PyTorch sum the same
    f32 terms in different orders)."""
    r = {k: np.asarray(v) for k, v in ref.items()}
    np.testing.assert_array_equal(ours["tokens"].numpy(), r["tokens"])
    np.testing.assert_array_equal(ours["lengths"].numpy(), r["lengths"])
    np.testing.assert_array_equal(ours["packed"].numpy()[:, :mt + 1],
                                  r["packed"][:, :mt + 1])
    for key in ("sum_logprob", "no_speech_prob"):
        np.testing.assert_allclose(ours[key].numpy(), r[key],
                                   rtol=1e-5, atol=1e-5)
    assert 1 <= ours["steps"] <= mt


CASES = {
    "plain": dict(),
    "timestamps": dict(timestamps=True),
    "self_kv8": dict(self_kv_bits=8),
    "cross_kv8": dict(cross_kv_bits=8),
    "cross_kv4": dict(cross_kv_bits=4),
    "timestamps_self_kv8_cross_kv4": dict(timestamps=True, self_kv_bits=8,
                                          cross_kv_bits=4),
    "max_tokens_13": dict(max_tokens=13, cross_kv_bits=8),
    "max_tokens_17_timestamps": dict(max_tokens=17, timestamps=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_function_decode_matches_jax(weights, case):
    params, model = weights
    kw = _opt_kw(CASES[case])
    audio = _audio(3, seed=1)
    toks, lens = _prompts(3, kw.get("timestamps", False))
    ref = jdec.greedy_decode_from_audio(
        params, jnp.asarray(audio), jnp.asarray(toks), jnp.asarray(lens),
        jw.WhisperDims(**KW), jdec.DecodeOptions(**kw), 16, target_len=TARGET)
    ours = tdec.greedy_decode_from_audio(
        model, torch.from_numpy(audio), torch.from_numpy(toks),
        torch.from_numpy(lens), tw.WhisperDims(**KW),
        tdec.DecodeOptions(**kw), 16, target_len=TARGET)
    _assert_same(ours, ref, kw["max_tokens"])
    assert (np.asarray(ref["tokens"]) != EOT).any()   # not a trivial decode
    if kw.get("timestamps"):
        assert (np.asarray(ref["tokens"]) >= TSB).any()


@pytest.mark.parametrize("timestamps", [False, True])
def test_prompt_reaching_the_context_end_matches_jax(timestamps):
    """A row whose prompt leaves 3 slots of a 24-slot text context
    force-finishes at the context end, as in JAX; the other row decodes on."""
    kw_dims = dict(KW, n_text_ctx=24)
    params, model = _weights(kw_dims, seed=2)
    tail = [SOT] if timestamps else [SOT, NO_TS]
    long_prompt = [(7 * i) % 200 + 1 for i in range(21 - len(tail))] + tail
    toks, lens = jdec.build_prompt_batch([long_prompt, tail], 21, EOT)
    kw = _opt_kw(dict(timestamps=timestamps, max_tokens=9))
    audio = _audio(2, seed=3)
    ref = jdec.greedy_decode_from_audio(
        params, jnp.asarray(audio), jnp.asarray(toks), jnp.asarray(lens),
        jw.WhisperDims(**kw_dims), jdec.DecodeOptions(**kw), 21,
        target_len=TARGET)
    ours = tdec.greedy_decode_from_audio(
        model, torch.from_numpy(audio), torch.from_numpy(toks),
        torch.from_numpy(lens), tw.WhisperDims(**kw_dims),
        tdec.DecodeOptions(**kw), 21, target_len=TARGET)
    _assert_same(ours, ref, 9)
    assert int(ours["lengths"][0]) <= 3          # the context ended row 0


def _chunked(model, mel, toks, lens, opts, max_p):
    """greedy_decode's loop as the graph route runs it, with chunks of
    decode_graph.K steps (``_greedy_steps``, the captured function) run
    eagerly and the stop flag read through ``decode_graph.drive``."""
    B, P = toks.shape
    cross_kv, self_kv, logits, pad, max_len = tdec._prefill(
        model, mel, toks, lens, tw.WhisperDims(**KW), opts, max_p,
        spare=decode_graph.K)
    M = max_len + decode_graph.K
    c = tdec._loop_inputs(model, tw.WhisperDims(**KW), opts, cross_kv, lens,
                          pad, P, M, logits.shape[-1], None)
    s = tdec._new_state(B, opts.max_tokens + decode_graph.K, self_kv,
                        mel.device)
    tdec._start_loop(s, c, logits[:, -1, :], opts)
    n_chunks = -(-(opts.max_tokens - 1) // decode_graph.K)
    steps, launched, reads = decode_graph.drive(
        lambda i: tdec._greedy_steps(s, c), s.ctl, n_chunks,
        decode_graph.StopFlags(torch.device("cpu")))
    return s, steps, launched, reads, n_chunks


@pytest.mark.parametrize("case", [
    dict(max_tokens=10),                                   # EOT ends rows
    dict(max_tokens=13, eot=-1, timestamps=True),          # runs to the end
    dict(max_tokens=21, eot=-1, self_kv_bits=8, cross_kv_bits=4),
])
def test_k_step_chunks_with_overrun_give_the_eager_result(weights, case):
    """The chunks run past the loop's end (up to K - 1 steps past
    max_tokens, and whole chunks after every row finished); tokens,
    sum_logprob and the loop's step count equal the step-by-step loop's
    bit for bit, and the stop flag is read at most ceil(steps / K) + 1
    times."""
    _, model = weights
    case = dict(case)
    eot = case.pop("eot", EOT)
    kw = _opt_kw(case)
    kw["eot"] = eot
    opts = tdec.DecodeOptions(**kw)
    from clearconverse_tpu_torch.audio.mel import log_mel_auto, pad_or_trim
    audio = torch.from_numpy(_audio(3, seed=4))
    mel = log_mel_auto(pad_or_trim(audio, TARGET), KW["n_mels"])
    toks, lens = (torch.from_numpy(x).long()
                  for x in _prompts(3, kw.get("timestamps", False)))
    with torch.inference_mode():
        eager = tdec.greedy_decode(model, mel, toks, lens,
                                   tw.WhisperDims(**KW), opts, 16)
        s, steps, launched, reads, n_chunks = _chunked(model, mel, toks,
                                                       lens, opts, 16)
    mt = opts.max_tokens
    assert steps + 1 == eager["steps"]
    np.testing.assert_array_equal(s.tokens[:, :mt].numpy(),
                                  eager["tokens"].numpy())
    np.testing.assert_array_equal(s.slp.numpy(),
                                  eager["sum_logprob"].numpy())
    # Overrun wrote only EOT past max_tokens, and K steps a chunk ran.
    assert (s.tokens[:, mt:] == eot).all()
    assert int(s.step) == 1 + launched * decode_graph.K
    assert reads <= -(-eager["steps"] // decode_graph.K) + 1
    assert launched <= n_chunks
    if eot == -1:
        assert eager["steps"] == mt and launched == n_chunks
        assert launched * decode_graph.K > mt - 1   # some steps overran


def test_drive_keeps_two_chunks_in_flight():
    """``drive`` launches chunk i + 1 before it reads chunk i's flag, reads
    each posted flag in order and stops at the first stop flag."""
    ctl = torch.zeros(2, dtype=torch.long)
    log = []

    def launch(i):
        log.append(("launch", i))
        ctl[0] = (i + 1) * decode_graph.K
        ctl[1] = int(i == 2)

    class Flags(decode_graph.StopFlags):
        def read(self, slot):
            out = super().read(slot)
            log.append(("read", out))
            return out

    steps, launched, reads = decode_graph.drive(
        launch, ctl, 6, Flags(torch.device("cpu")))
    K = decode_graph.K
    assert (steps, launched, reads) == (3 * K, 4, 3)
    assert log == [("launch", 0), ("launch", 1), ("read", (K, False)),
                   ("launch", 2), ("read", (2 * K, False)), ("launch", 3),
                   ("read", (3 * K, True))]
