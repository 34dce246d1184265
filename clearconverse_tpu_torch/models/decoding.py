"""Batched KV-cached Whisper decoding in PyTorch.

The JAX package's models/decoding.py decodes a whole segment batch in one
XLA program whose token loop is a ``lax.while_loop``. Here pad/trim,
log-mel (kernel K1 on CUDA), the encoder (kernel K2 on CUDA), head-major
cross-KV and prompt prefill run eagerly on the device; the token loop is
one step function, ``_greedy_step`` (``_beam_step`` for beam search), the
counterpart of the JAX loop's ``body``: every field of its state is a
device tensor, so a step never waits for the host. On a CUDA tensor the
loop runs as CUDA graphs of ``decode_graph.K`` consecutive steps, replayed
until a stop flag read a replay late says the loop has ended
(``models/decode_graph.py``), on a whole model and on a model-sharded mesh
rank over NCCL alike (the JAX package's model-sharded decode is the same
jitted program, its collectives inserted by XLA); on the CPU, and on a
model-sharded rank over gloo, the same step runs eagerly and the host reads
the stop flag after each step. Variable-length prompts keep exact
single-example numerics by giving real tokens their absolute positions and
masking padded cache slots forever.

Prompt layout per row: [sot_prev, ...context_tokens..., sot, (notimestamps)],
left-padded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from clearconverse_tpu_torch.models import decode_graph
from clearconverse_tpu_torch.models.whisper import (
    Whisper, WhisperDims, decoder_forward, init_kv_cache, precompute_cross_kv,
    tensor_parallel, unpack_codes, whisper_encode,
)
from clearconverse_tpu_torch.parallel.mesh import MODEL_AXIS
from clearconverse_tpu_torch.utils.tracing import StageTimer

logger = logging.getLogger(__name__)

_NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    max_tokens: int = 224            # generated tokens per segment
    temperature: float = 0.0         # 0 → greedy argmax (api.py:128 uses 0.1)
    eot: int = 50256                 # <|endoftext|> (english vocab layout)
    suppress_blank: bool = True
    blank_token: int = 220           # " " in GPT-2 BPE
    # Token ids suppressed at every step (non-speech symbols + specials +
    # the timestamp range in notimestamps decoding).
    suppress_tokens: Tuple[int, ...] = ()
    compute_dtype: Any = torch.float32
    # Cross-attention K/V storage width (16, 8 or 4 bits).
    cross_kv_bits: int = 16
    # Self-attention cache width (16 or 8).
    self_kv_bits: int = 16
    # <|nospeech|> token id; when >= 0 the result carries ``no_speech_prob``
    # read from the raw prefill logits at the SOT slot, which sits
    # ``sot_from_end`` slots before the prompt end.
    no_speech_token: int = -1
    sot_from_end: int = 2
    # Timestamp decoding (whisper ApplyTimestampRules, for the >30 s seek
    # path): tokens >= timestamp_begin are timestamps at 0.02 s. The first
    # sampled token is a timestamp (at most max_initial_timestamp_index),
    # timestamps pair up and never decrease, and when the total timestamp
    # probability beats the best text token the sample is a timestamp.
    timestamps: bool = False
    timestamp_begin: int = -1
    max_initial_timestamp_index: int = 50   # 1.0 s / 0.02
    # Sampling replicas per source row (whisper best_of). The audio/mel
    # batch carries UNIQUE rows; prompts/outputs carry rows × replicas
    # (replicas consecutive per row), and every replica group shares one
    # encoder forward and one cross-KV stream.
    replicas: int = 1
    # Beam search (whisper beam_size, applied on t == 0 rungs): True routes
    # greedy_decode_from_audio/store to beam_decode with ``replicas`` beams
    # per source row; needs temperature 0 and one prompt per replica group.
    beam: bool = False
    # (first row, total rows): this call's prompt rows are that block of a
    # larger batch (one data rank's share on a mesh), and each sampling
    # step draws the noise of the whole batch and keeps the block's rows,
    # so t > 0 samples what the whole batch would. (0, 0): its own rows.
    noise_rows: Tuple[int, int] = (0, 0)


def build_prompt_batch(prompt_lists, max_prompt_len: int, pad_id: int):
    """Left-pad variable-length prompt token lists → (tokens [B,P] int32,
    lengths [B] int32). Pure host-side helper."""
    b = len(prompt_lists)
    toks = np.full((b, max_prompt_len), pad_id, np.int32)
    lens = np.zeros((b,), np.int32)
    for i, p in enumerate(prompt_lists):
        p = list(p)[-max_prompt_len:]
        toks[i, max_prompt_len - len(p):] = p
        lens[i] = len(p)
    return toks, lens


def _suppress_mask(opts: DecodeOptions, vocab: int,
                   device: torch.device) -> torch.Tensor:
    """[vocab] bool, True at ``opts.suppress_tokens``: built on the device
    once per decode call, before the token loop."""
    mask = torch.zeros(vocab, dtype=torch.bool, device=device)
    if opts.suppress_tokens:
        ids = torch.tensor(opts.suppress_tokens, dtype=torch.long)
        mask[ids.to(device)] = True
    return mask


def _suppress(logits: torch.Tensor, opts: DecodeOptions, is_first: bool,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Whisper's suppression: the static id set at every step (``mask``,
    from ``_suppress_mask``; built here when not given), plus blank and EOT
    on the first sampled token."""
    if mask is None:
        mask = _suppress_mask(opts, logits.shape[-1], logits.device)
    logits = logits.masked_fill(mask, _NEG_INF)
    if opts.suppress_blank and is_first:
        logits[..., [opts.blank_token, opts.eot]] = _NEG_INF
    return logits


def _timestamp_rules(logits: torch.Tensor, opts: DecodeOptions,
                     is_first: bool, prev: torch.Tensor, prev2: torch.Tensor,
                     last_ts: torch.Tensor, step) -> torch.Tensor:
    """whisper ApplyTimestampRules on [B, V] f32 logits. ``prev``/``prev2``
    are the last two sampled tokens (-1 = none); ``last_ts`` is the latest
    sampled timestamp token (-1 = none); ``step`` (an int or a 0-d device
    tensor) is the index of the token being sampled."""
    tsb = opts.timestamp_begin
    idx = torch.arange(logits.shape[-1], device=logits.device)[None, :]
    ts_region = idx >= tsb
    if is_first:
        # The first sampled token is a timestamp of at most 1.0 s.
        logits = logits.masked_fill(
            (idx < tsb) | (idx > tsb + opts.max_initial_timestamp_index),
            _NEG_INF)
    else:
        last_was = prev >= tsb
        pen_was = (prev2 >= tsb) | (step < 2)
        # A closed pair (or a lone initial timestamp) → text next; an open
        # end candidate → a timestamp or EOT next.
        r1 = (last_was & pen_was)[:, None] & ts_region
        r2 = (last_was & ~pen_was)[:, None] & (idx < opts.eot)
        # Non-decreasing; after a closed pair, strictly greater.
        min_allowed = torch.where(
            last_ts < 0, torch.full_like(last_ts, tsb),
            torch.where(last_was & ~pen_was, last_ts, last_ts + 1))
        r3 = ts_region & (idx < min_allowed[:, None])
        logits = logits.masked_fill(r1 | r2 | r3, _NEG_INF)
    # When the total timestamp probability beats every text token, force a
    # timestamp (whisper's sum-of-logprobs rule).
    logp = F.log_softmax(logits, dim=-1)
    force = (torch.logsumexp(logp[:, tsb:], dim=-1)
             > logp[:, :tsb].amax(dim=-1))
    return logits.masked_fill(force[:, None] & (idx < tsb), _NEG_INF)


def _pick(logits: torch.Tensor, opts: DecodeOptions,
          generator: Optional[torch.Generator],
          temperature: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy argmax at t = 0; at t > 0 a categorical sample as
    argmax(logits / t + Gumbel noise), the noise drawn from ``generator``
    (not the JAX package's random bits). ``temperature``, a 0-d f32 device
    tensor, carries t into the token loop, so one captured loop serves
    every t > 0; without it t is ``opts.temperature``. ``opts.noise_rows``
    draws the noise of a larger batch and keeps this call's block of it."""
    if opts.temperature > 0 and generator is not None:
        lo, total = opts.noise_rows
        shape = (total, logits.shape[-1]) if total else logits.shape
        u = torch.rand(shape, generator=generator, device=logits.device,
                       dtype=torch.float32)[lo:lo + logits.shape[0]]
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        t = opts.temperature if temperature is None else temperature
        return torch.argmax(logits / t + gumbel, dim=-1)
    return torch.argmax(logits, dim=-1)


def gather_windows(store: torch.Tensor, rows: torch.Tensor,
                   starts: torch.Tensor, lens: torch.Tensor,
                   bucket: int) -> torch.Tensor:
    """Fixed-length windows out of device-resident full-file audio:
    [N, T] store + (row, start, len)[B] → [B, bucket], zero past len.

    Rows and starts clamp as ``lax.dynamic_slice`` does, so a window always
    lies inside the store (which carries >= bucket trailing zeros)."""
    n, t = store.shape
    rows = rows.long().clamp(0, n - 1)
    starts = starts.long().clamp(0, t - bucket)
    ar = torch.arange(bucket, device=store.device)
    w = store[rows[:, None], starts[:, None] + ar[None, :]]
    return w * (ar[None, :] < lens.long()[:, None]).to(w.dtype)


def greedy_decode_from_store(
    model: Whisper,
    store: torch.Tensor,
    rows: torch.Tensor,
    starts: torch.Tensor,
    lens: torch.Tensor,
    prompt_tokens: torch.Tensor,
    prompt_lens: torch.Tensor,
    dims: WhisperDims,
    opts: DecodeOptions,
    max_prompt_len: int,
    generator: Optional[torch.Generator] = None,
    target_len: int = 30 * 16000,
    bucket: int = 30 * 16000,
    timer: Optional[StageTimer] = None,
) -> Dict[str, torch.Tensor]:
    """gather + pad/mel + decode over store windows."""
    with _span(timer, "gather"):
        audio = gather_windows(store, rows, starts, lens, bucket)
    return greedy_decode_from_audio(model, audio, prompt_tokens, prompt_lens,
                                    dims, opts, max_prompt_len, generator,
                                    target_len=target_len, timer=timer)


def greedy_decode_from_audio(
    model: Whisper,
    audio: torch.Tensor,             # [B, T] 16 kHz waveform (any length)
    prompt_tokens: torch.Tensor,
    prompt_lens: torch.Tensor,
    dims: WhisperDims,
    opts: DecodeOptions,
    max_prompt_len: int,
    generator: Optional[torch.Generator] = None,
    target_len: int = 30 * 16000,
    timer: Optional[StageTimer] = None,
) -> Dict[str, torch.Tensor]:
    """pad/trim + log-mel + decode: ``beam_decode`` when ``opts.beam`` (and
    more than one replica), else ``greedy_decode``."""
    from clearconverse_tpu_torch.audio.mel import log_mel_auto, pad_or_trim

    with _span(timer, "log_mel"):
        mel = log_mel_auto(pad_or_trim(audio.float(), target_len), dims.n_mels)
    if opts.beam and opts.replicas > 1:
        return beam_decode(model, mel, prompt_tokens, prompt_lens, dims, opts,
                           max_prompt_len, timer)
    return greedy_decode(model, mel, prompt_tokens, prompt_lens, dims, opts,
                         max_prompt_len, generator, timer)


def _span(timer: Optional[StageTimer], name: str):
    """``timer``'s span ``name``; without a timer, a span of a timer that is
    dropped, so only its profiler range (``cc:decode.<name>``, while the
    profiler runs) is kept."""
    return (timer or StageTimer()).stage(name, scope="decode")


def _widen_codes(ckv: Dict[str, Any], cdt: torch.dtype) -> Dict[str, Any]:
    """int8 or packed int4 cross-KV codes → the compute dtype, once per
    call (int4 unpacked here, with both nibbles sign-extended). |code| <=
    127 is exact in bf16 and f32, so the decode numerics are those of the
    codes; the per-step cast of the JAX version becomes a no-op."""
    return {name: ({"q": unpack_codes(val).to(cdt), "scale": val["scale"]}
                   if isinstance(val, dict) else val)
            for name, val in ckv.items()}


def _prefill(model, mel, prompt_tokens, prompt_lens, dims, opts,
             max_prompt_len, timer: Optional[StageTimer] = None,
             spare: int = 0,
             bufs: Optional[decode_graph.GraphBuffers] = None):
    """Encode → cross-KV → prompt prefill. Returns (cross_kv, self_kv,
    prefill logits [B, P, V], pad [B, 1], max_len).

    ``mel`` carries B // opts.replicas unique rows (see DecodeOptions). The
    self-KV cache holds max_len + ``spare`` slots. ``bufs`` (a decode
    graph's buffers) supplies the cross-KV destinations and the zeroed
    self-KV cache, so the captured loop finds them at fixed addresses."""
    B, P = prompt_tokens.shape
    max_len = max_prompt_len + opts.max_tokens
    cdt = opts.compute_dtype
    dev = mel.device
    if B % max(opts.replicas, 1) or mel.shape[0] * opts.replicas != B:
        raise ValueError(
            f"prompt rows ({B}) must be mel rows ({mel.shape[0]}) x "
            f"replicas ({opts.replicas})")

    with _span(timer, "encoder"):
        audio = whisper_encode(model, mel, dims, cdt)
    with _span(timer, "cross_kv"):
        if bufs is None:
            cross_kv = [_widen_codes(c, cdt) for c in precompute_cross_kv(
                model, audio, n_head=dims.n_text_head, bits=opts.cross_kv_bits)]
        else:
            cross_kv = precompute_cross_kv(
                model, audio, n_head=dims.n_text_head,
                bits=opts.cross_kv_bits, out=bufs.cross_kv)
    if bufs is None:
        self_kv = init_kv_cache(dims, B, max_len + spare, cdt,
                                bits=opts.self_kv_bits, device=dev,
                                tp=tensor_parallel(model))
    else:
        self_kv = bufs.self_kv

    pad = (P - prompt_lens)[:, None]                      # [B,1]
    slot = torch.arange(P, device=dev)[None, :]
    positions = torch.clamp(slot - pad, 0, dims.n_text_ctx - 1)

    # Prefill mask: query q sees key k iff k <= q (causal) and k is a real
    # prompt slot. Cache slots >= P are unwritten → hidden.
    kslot = torch.arange(max_len + spare, device=dev)[None, None, None, :]
    qslot = torch.arange(P, device=dev)[None, None, :, None]
    causal = kslot <= qslot
    kvalid = (kslot >= pad[:, None, None, :]) & (kslot < P)
    prefill_mask = torch.where(causal & kvalid, 0.0, _NEG_INF).float()

    with _span(timer, "prefill"):
        logits, self_kv = decoder_forward(
            model, prompt_tokens, positions, 0, self_kv, cross_kv,
            prefill_mask, None, dims, cdt)
    return cross_kv, self_kv, logits, pad, max_len


def _no_speech_from_prefill(logits, opts, P):
    """Whisper's silence signal: P(no_speech) from the raw prefill logits
    at the SOT input slot."""
    if opts.no_speech_token < 0:
        return torch.zeros(logits.shape[0], dtype=torch.float32,
                           device=logits.device)
    sot_logits = logits[:, P - opts.sot_from_end, :].float()
    return torch.softmax(sot_logits, dim=-1)[:, opts.no_speech_token]


def _finalize_decode(tokens, slp, no_speech_prob, opts):
    """EOT-derived lengths + the one-array "packed" result
    [B, max_tokens + 3] int32 (tokens, length, bitcast sum_logprob, bitcast
    no_speech_prob), so the host fetches a decode with ONE copy."""
    is_eot = tokens == opts.eot
    lengths = torch.where(is_eot.any(dim=1), is_eot.int().argmax(dim=1),
                          opts.max_tokens)
    packed = torch.cat(
        [tokens.int(), lengths[:, None].int(),
         slp.float().view(torch.int32)[:, None],
         no_speech_prob.float().view(torch.int32)[:, None]], dim=1)
    return {"tokens": tokens, "lengths": lengths, "sum_logprob": slp,
            "no_speech_prob": no_speech_prob, "packed": packed}


@dataclasses.dataclass
class _LoopState:
    """The token loop's carry, the JAX ``while_loop`` state ``(step,
    tokens, kv, finished, slp, prev, prev2, last_ts)``: every field a
    device tensor, updated in place. ``ctl`` = [loop steps taken, stop]
    (long) is what the host reads back."""

    step: torch.Tensor        # 0-d long: the index of the token being sampled
    tokens: torch.Tensor      # [B, max_tokens + K] long, EOT after the end
    kv: List[Dict[str, torch.Tensor]]
    finished: torch.Tensor    # [B] bool
    slp: torch.Tensor         # [B] f32 sum of the sampled tokens' logprobs
    prev: torch.Tensor        # [B] long: the last sampled token
    prev2: torch.Tensor       # [B] long: the one before (-1 = none)
    last_ts: torch.Tensor     # [B] long: the latest timestamp (-1 = none)
    ctl: torch.Tensor         # [2] long


@dataclasses.dataclass
class _LoopInputs:
    """What a step reads and never writes. The tensors are refilled by
    every call of a captured loop; the rest is fixed by its graph key."""

    model: Optional[Whisper]
    dims: WhisperDims
    opts: DecodeOptions
    cross_kv: List[Dict[str, Any]]
    P: int                     # prompt slots
    kslot: torch.Tensor        # [1, 1, 1, M] cache slot index
    prompt_lens: torch.Tensor  # [B] long
    padded: torch.Tensor       # [B, 1, 1, M] bool: left-pad slots
    suppress: torch.Tensor     # [V] bool (_suppress_mask)
    temperature: torch.Tensor  # 0-d f32
    generator: Optional[torch.Generator]


def _loop_inputs(model, dims, opts, cross_kv, prompt_lens, pad, P: int,
                 M: int, V: int, generator) -> _LoopInputs:
    dev = prompt_lens.device
    kslot = torch.arange(M, device=dev)[None, None, None, :]
    return _LoopInputs(
        model, dims, opts, cross_kv, P, kslot, prompt_lens,
        kslot < pad[:, None, None, :], _suppress_mask(opts, V, dev),
        torch.full((), float(opts.temperature), dtype=torch.float32,
                   device=dev), generator)


def _new_state(B: int, cols: int, kv, dev) -> _LoopState:
    def e(*shape, dtype=torch.long):
        return torch.empty(shape, dtype=dtype, device=dev)
    return _LoopState(e(), e(B, cols), kv, e(B, dtype=torch.bool),
                      e(B, dtype=torch.float32), e(B), e(B), e(B), e(2))


def _start_loop(s: _LoopState, c: _LoopInputs, last_logits: torch.Tensor,
                opts: DecodeOptions) -> None:
    """The first sampled token (from the prefill's last logits) and the
    loop's initial state, written into ``s``."""
    eot = opts.eot
    first = _suppress(last_logits, opts, True, c.suppress)
    none = torch.full_like(s.prev, -1)
    if opts.timestamps:
        first = _timestamp_rules(first, opts, True, none, none, none, 0)
    logp0 = F.log_softmax(first, dim=-1)
    tok0 = _pick(first, opts, c.generator, c.temperature)
    s.step.fill_(1)
    s.tokens.fill_(eot)
    s.tokens[:, 0] = tok0
    s.finished.copy_(tok0 == eot)
    s.slp.copy_(logp0.gather(1, tok0[:, None])[:, 0])
    s.prev.copy_(tok0)
    s.prev2.copy_(none)
    s.last_ts.copy_(torch.where(tok0 >= opts.timestamp_begin, tok0, none)
                    if opts.timestamps else none)
    s.ctl[0] = 0
    s.ctl[1].copy_(s.finished.all() | (opts.max_tokens <= 1))


def _greedy_step(s: _LoopState, c: _LoopInputs) -> None:
    """One token for every row, in place: the JAX loop's ``body``. Reads
    nothing from the host, so K of them capture into one CUDA graph.
    Past the loop's end (the JAX ``cond`` false: every row finished, or
    ``max_tokens`` reached) every row counts as done, so such a step writes
    EOT, adds nothing to ``slp`` and leaves ``ctl`` as it was."""
    opts, dims = c.opts, c.dims
    step = s.step
    live = ~s.finished.all() & (step < opts.max_tokens)
    # prev = token generated at step-1; its absolute position is
    # prompt_len + step - 1 and its K/V land in cache slot P + step - 1.
    pos = torch.clamp(c.prompt_lens + step - 1, 0, dims.n_text_ctx - 1)
    mask = torch.where(c.padded | (c.kslot > step + (c.P - 1)), _NEG_INF, 0.0)
    logits, _ = decoder_forward(
        c.model, s.prev[:, None], pos[:, None], step + (c.P - 1), s.kv,
        c.cross_kv, mask, None, dims, opts.compute_dtype)
    lg = _suppress(logits[:, 0, :], opts, False, c.suppress)
    if opts.timestamps:
        lg = _timestamp_rules(lg, opts, False, s.prev, s.prev2, s.last_ts,
                              step)
    logp = F.log_softmax(lg, dim=-1)
    pick = _pick(lg, opts, c.generator, c.temperature)
    # openai-whisper caps sample_len so prompt+generation <= n_text_ctx;
    # rows whose prompt reaches the context end force-finish. A done row's
    # logprob is read at its (valid) pick and dropped: EOT may be -1.
    done = (s.finished | ((c.prompt_lens + step) >= dims.n_text_ctx)
            | (step >= opts.max_tokens))
    nxt = torch.where(done, opts.eot, pick)
    s.slp.add_(torch.where(done, 0.0, logp.gather(1, pick[:, None])[:, 0]))
    s.tokens.index_copy_(1, step.reshape(1), nxt[:, None])
    if opts.timestamps:
        s.last_ts.copy_(torch.where((nxt >= opts.timestamp_begin) & ~done,
                                    nxt, s.last_ts))
    s.finished.copy_(done | (nxt == opts.eot))
    s.prev2.copy_(s.prev)
    s.prev.copy_(nxt)
    s.ctl[0].add_(live.long())
    step.add_(1)
    s.ctl[1].copy_(s.finished.all() | (step >= opts.max_tokens))


def _agree(ctl: torch.Tensor, model) -> None:
    """On a model-sharded rank, the control pair [steps, stop] after a
    chunk made one value on every rank of the model axis: its max over the
    axis, or [-1, 1] where the ranks' pairs differ (``decode_graph.drive``
    raises on -1). The ranks compute equal pairs (``_graph_route``), so
    this changes no value. It is one collective a chunk, captured with it,
    and it turns a disagreement into an error on every rank at the same
    flag read, where a rank that stopped alone would leave the others
    replaying a chunk whose collectives wait for ever."""
    tp = tensor_parallel(model)
    if tp is None:
        return
    v = torch.cat([ctl, -ctl])
    tp.mesh.all_reduce(v, MODEL_AXIS, op="max")
    differ = (v[:2] != -v[2:]).any()
    ctl[0].copy_(torch.where(differ, -1, v[0]))
    ctl[1].copy_(torch.where(differ, 1, v[1]))


def _greedy_steps(s: _LoopState, c: _LoopInputs) -> None:
    """``decode_graph.K`` steps: what one decode graph captures."""
    for _ in range(decode_graph.K):
        _greedy_step(s, c)
    _agree(s.ctl, c.model)


def _loop_eager(s, c: _LoopInputs, step=_greedy_step) -> int:
    """The token loop one ``step`` at a time (``_greedy_step`` or
    ``_beam_step``), the host reading the stop flag after each. Returns the
    loop steps taken."""
    while not bool(s.ctl[1]):
        step(s, c)
    return int(s.ctl[0])


def _keyed_loop(bufs: decode_graph.GraphBuffers, c,
                new_state: Callable[[], Any],
                refill=("prompt_lens", "padded", "suppress", "temperature")):
    """The graph route's loop state and inputs: made on the key's first
    call (``new_state()``), after that the same tensors with this call's
    inputs (``refill``, the fields of ``c`` a call may change) copied in,
    so the captured graph finds them where it left them. The graph's
    inputs hold no model: the graphs are dropped with the model, so they
    must not keep it."""
    if bufs.state is None:
        bufs.state = new_state()
        bufs.inputs = dataclasses.replace(c, model=None)
    else:
        for name in refill:
            getattr(bufs.inputs, name).copy_(getattr(c, name))
    return bufs.state, dataclasses.replace(bufs.inputs, model=c.model,
                                           opts=c.opts)


@functools.lru_cache(maxsize=None)
def _log_eager_route() -> None:
    logger.info("decode: a model-sharded rank over gloo runs the token loop "
                "eagerly (its step holds collectives, and a CUDA graph "
                "captures NCCL's, not gloo's)")


def _graph_route(model: Whisper, device: torch.device) -> bool:
    """True when the token loop runs as CUDA graphs: every CUDA call on a
    whole model (1×1 and data-only meshes), and on a model-sharded rank
    whose mesh runs over NCCL (one card a rank). A model-sharded rank over
    gloo (ranks sharing a card) keeps the eager step, logged once.

    A sharded rank's graph holds the step's collectives, so every rank of
    the model axis must replay the same chunks: each decides to stop from
    values that are bitwise equal on all of them. The residual stream
    starts from replicated embeddings; each sharded product's partial sums
    meet in one all-reduce, whose result is the same bits on every rank
    (each element is reduced once and copied to the others, over NCCL and
    gloo alike); layer norms, biases, the vocabulary projection and the
    pick are replicated work on equal inputs; at t > 0 every rank's
    generator is reseeded from the caller's seed, which the ranks share (a
    serving follower replays rank 0's calls in order). ``_agree`` makes the
    stop flag one value all the same, and raises on a difference."""
    if device.type != "cuda":
        return False
    tp = tensor_parallel(model)
    if tp is not None and tp.mesh.backend != "nccl":
        _log_eager_route()
        return False
    return True


def _graph_buffers(graphs: decode_graph.DecodeGraphs, model, mel, B: int,
                   P: int, max_len: int, dims: WhisperDims,
                   opts: DecodeOptions, sampling: bool):
    """The decode graph buffers of this call's static key: the JAX jit's
    (rows, encoder frames, prompt slots, max_len, options), with only
    "t > 0" of the temperature and no suppression set (both are device
    inputs of the graph). ``opts.beam`` and ``opts.replicas`` keep a beam
    key apart from a greedy or best_of one of the same rows; the arena
    holds ``mel`` rows (B / replicas) of cross-KV and B of self-KV, with
    the heads this rank attends with (a shard's ``tp.heads``, as
    ``precompute_cross_kv`` and ``init_kv_cache(tp=)`` give them). A
    shard's key is its own: its graphs live with the shard module
    (``decode_graph.graphs_for``) and ``weights_key`` reads its tensors."""
    key = (B, mel.shape[0], mel.shape[-1], P, max_len, sampling,
           dataclasses.replace(opts, temperature=float(opts.temperature > 0),
                               suppress_tokens=()))
    tp = tensor_parallel(model)
    heads = dims.n_text_head if tp is None else tp.heads(dims.n_text_head)
    layout = decode_graph.Layout(
        dims.n_text_layer, heads, dims.head_dim,
        opts.compute_dtype, opts.cross_kv_bits != 16, opts.self_kv_bits)
    frames = (mel.shape[-1] - 1) // 2 + 1        # conv2: stride 2, pad 1
    return graphs.buffers(key, layout, mel.shape[0], B, frames,
                          max_len + decode_graph.K,
                          decode_graph.weights_key(model), sampling)


@torch.inference_mode()
def greedy_decode(
    model: Whisper,
    mel: torch.Tensor,               # [B // replicas, n_mels, T_frames]
    prompt_tokens: torch.Tensor,     # [B, P] left-padded
    prompt_lens: torch.Tensor,       # [B]
    dims: WhisperDims,
    opts: DecodeOptions,
    max_prompt_len: int,
    generator: Optional[torch.Generator] = None,
    timer: Optional[StageTimer] = None,
) -> Dict[str, torch.Tensor]:
    """Encode → prefill → token loop. Returns {"tokens": [B, max_tokens],
    "lengths": [B], "sum_logprob": [B], "no_speech_prob": [B], "packed",
    "steps"} — ``tokens`` is EOT-padded after each row's end;
    ``no_speech_prob`` is zeros unless opts.no_speech_token is set;
    ``steps`` (a host int) counts the token positions decoded. ``timer``,
    when given, records the stages' spans (gather, log_mel, encoder,
    cross_kv, prefill, token_loop; graph_capture inside token_loop when a
    graph is captured) and counts the loop's steps (``token_loop_steps``)
    and, on the graph route, its replays, captures and stop-flag reads.

    On a CUDA tensor the token loop runs as CUDA graphs (``_graph_route``:
    not on a model-sharded rank over gloo; models/decode_graph.py); at
    t > 0 their generator is reseeded from ``generator.initial_seed()``,
    and ``generator`` itself is not advanced."""
    prompt_tokens = prompt_tokens.long()
    prompt_lens = prompt_lens.long()
    B, P = prompt_tokens.shape
    if P > max_prompt_len:
        raise ValueError(f"prompt slots ({P}) exceed max_prompt_len "
                         f"({max_prompt_len})")
    dev = mel.device
    mt = opts.max_tokens
    graphs = decode_graph.graphs_for(model) if _graph_route(model, dev) \
        else None
    with graphs.lock if graphs is not None else contextlib.nullcontext():
        bufs = None
        sampling = opts.temperature > 0 and generator is not None
        if graphs is not None:
            bufs = _graph_buffers(graphs, model, mel, B, P,
                                  max_prompt_len + mt, dims, opts, sampling)
        cross_kv, self_kv, logits, pad, max_len = _prefill(
            model, mel, prompt_tokens, prompt_lens, dims, opts,
            max_prompt_len, timer, spare=decode_graph.K, bufs=bufs)
        no_speech_prob = _no_speech_from_prefill(logits, opts, P)

        with _span(timer, "token_loop"):
            gen = generator
            if bufs is not None and bufs.generator is not None:
                gen = bufs.generator
                gen.manual_seed(generator.initial_seed())
            c = _loop_inputs(model, dims, opts, cross_kv, prompt_lens, pad,
                             P, max_len + decode_graph.K, logits.shape[-1],
                             gen)
            new_state = functools.partial(
                _new_state, B, mt + decode_graph.K, self_kv, dev)
            if bufs is None:
                s = new_state()
            else:
                s, c = _keyed_loop(bufs, c, new_state)
            _start_loop(s, c, logits[:, -1, :], opts)
            if bufs is None:
                loop_steps = _loop_eager(s, c)
            else:
                loop_steps = graphs.run(
                    bufs, functools.partial(_greedy_steps, s, c), s.ctl,
                    -(-(mt - 1) // decode_graph.K), timer) if mt > 1 else 0
            tokens, slp = s.tokens[:, :mt].clone(), s.slp.clone()

    if timer is not None:
        timer.count("token_loop_steps", loop_steps)
    out = _finalize_decode(tokens, slp, no_speech_prob, opts)
    out["steps"] = loop_steps + 1    # token positions decoded
    return out


@dataclasses.dataclass
class _BeamState:
    """beam_decode's carry, the JAX ``while_loop`` state ``(step, tokens,
    kv, slp, prev, prev2, last_ts, fin_tokens, fin_scores, fin_count)``:
    every field a device tensor, updated in place. ``ctl`` = [loop steps
    taken, stop] (long), as in ``_LoopState``."""

    step: torch.Tensor        # 0-d long: the index of the token being chosen
    tokens: torch.Tensor      # [B, max_tokens + K] long: each beam's history
    kv: List[Dict[str, torch.Tensor]]
    slp: torch.Tensor         # [B] f32 cumulative logprob of each live beam
    prev: torch.Tensor        # [B] long: each beam's last token
    prev2: torch.Tensor       # [B] long: the one before (-1 = none)
    last_ts: torch.Tensor     # [B] long: the latest timestamp (-1 = none)
    fin_tokens: torch.Tensor  # [G, R + 1, max_tokens] long; slot R drops
    fin_scores: torch.Tensor  # [G, R + 1] f32
    fin_count: torch.Tensor   # [G] long: finished sequences stored
    ctl: torch.Tensor         # [2] long


def _new_beam_state(B: int, R: int, mt: int, kv, dev) -> _BeamState:
    def e(*shape, dtype=torch.long):
        return torch.empty(shape, dtype=dtype, device=dev)
    G = B // R
    return _BeamState(e(), e(B, mt + decode_graph.K), kv,
                      e(B, dtype=torch.float32), e(B), e(B), e(B),
                      e(G, R + 1, mt), e(G, R + 1, dtype=torch.float32),
                      e(G), e(2))


def _beam_store(s: _BeamState, ord_sc: torch.Tensor, ord_idx: torch.Tensor,
                slots: torch.Tensor, keep: torch.Tensor) -> None:
    """Write the histories of beams ``ord_idx`` ([G, R] beam indices per
    group) with scores ``ord_sc`` into store slots ``slots`` where ``keep``.
    The rest go to the spare slot R, which nothing reads: a fixed-shape
    scatter, the JAX ``.at[].set(mode="drop")``, with no host read."""
    G, R1, mt = s.fin_tokens.shape
    R = R1 - 1
    hist = s.tokens.reshape(G, R, -1)[:, :, :mt].gather(
        1, ord_idx[:, :, None].expand(G, R, mt))
    slot_w = torch.where(keep, slots, R)
    g = torch.arange(G, device=slots.device)[:, None].expand(G, R)
    s.fin_tokens.index_put_((g, slot_w), hist)
    s.fin_scores.index_put_((g, slot_w), ord_sc)


def _beam_stop(s: _BeamState, c: _LoopInputs) -> torch.Tensor:
    """The negated JAX ``cond`` at the state's step (0-d bool): max_tokens
    reached, or every group full or at the context end."""
    R = c.opts.replicas
    plen_g = c.prompt_lens.reshape(-1, R)[:, 0]
    ended = (s.fin_count >= R) | ((plen_g + s.step) >= c.dims.n_text_ctx)
    return ended.all() | (s.step >= c.opts.max_tokens)


def _start_beam(s: _BeamState, c: _LoopInputs,
                last_logits: torch.Tensor) -> None:
    """Step 0 (from the prefill's last logits) and the loop's initial
    state, written into ``s``. The R beams of a group hold one prompt, so
    their logits are identical and whisper's first update dedups them into
    one distribution: live = its top R non-EOT tokens; an EOT outranking
    the R-th of them seeds the finished store."""
    opts = c.opts
    eot, R = opts.eot, opts.replicas
    B = s.prev.shape[0]
    G = B // R
    first = _suppress(last_logits, opts, True, c.suppress)
    none = torch.full_like(s.prev, -1)
    if opts.timestamps:
        first = _timestamp_rules(first, opts, True, none, none, none, 0)
    logp0 = F.log_softmax(first.float(), dim=-1)
    l0 = logp0.reshape(G, R, -1)[:, 0, :]
    eot0 = l0[:, eot]
    s0, t0 = torch.topk(l0.index_fill(
        1, torch.tensor([eot], device=l0.device), float("-inf")), R, dim=-1)
    tok0 = t0.reshape(B)
    s.step.fill_(1)
    s.tokens.fill_(eot)
    s.tokens[:, 0] = tok0
    s.slp.copy_(s0.reshape(B))
    s.prev.copy_(tok0)
    s.prev2.copy_(none)
    s.last_ts.copy_(torch.where(tok0 >= opts.timestamp_begin, tok0, none)
                    if opts.timestamps else none)
    eot_valid0 = eot0 > s0[:, R - 1]
    # The store: an all-EOT token row is the empty sequence.
    s.fin_tokens.fill_(eot)
    s.fin_scores.fill_(float("-inf"))
    s.fin_scores[:, 0] = torch.where(eot_valid0, eot0,
                                     torch.full_like(eot0, float("-inf")))
    s.fin_count.copy_(eot_valid0.long())
    s.ctl[0] = 0
    s.ctl[1].copy_(_beam_stop(s, c))


def _beam_step(s: _BeamState, c: _LoopInputs) -> None:
    """One beam-search step for every group, in place: the JAX loop's
    ``body``. Reads nothing from the host, so K of them capture into one
    CUDA graph. A step past the loop's end (``ctl[1]`` set: the JAX
    ``cond`` false) treats every beam as frozen, so it stores nothing and
    leaves the beams, their cache rows and ``ctl[0]`` as they were."""
    opts, dims = c.opts, c.dims
    eot, R = opts.eot, opts.replicas
    B = s.prev.shape[0]
    G = B // R
    step = s.step
    live = s.ctl[1] == 0
    pos = torch.clamp(c.prompt_lens + step - 1, 0, dims.n_text_ctx - 1)
    mask = torch.where(c.padded | (c.kslot > step + (c.P - 1)), _NEG_INF, 0.0)
    logits, _ = decoder_forward(
        c.model, s.prev[:, None], pos[:, None], step + (c.P - 1), s.kv,
        c.cross_kv, mask, None, dims, opts.compute_dtype)
    lg = _suppress(logits[:, 0, :], opts, False, c.suppress)
    if opts.timestamps:
        lg = _timestamp_rules(lg, opts, False, s.prev, s.prev2, s.last_ts,
                              step)
    logp = F.log_softmax(lg.float(), dim=-1)
    V = logp.shape[-1]
    # Context-full groups freeze in place; their live beams fill the store
    # at finalize, like whisper's loop break.
    frozen = ((c.prompt_lens + step) >= dims.n_text_ctx) | ~live    # [B]
    plen_g = c.prompt_lens.reshape(G, R)[:, 0]
    active_g = ((plen_g + step) < dims.n_text_ctx) & live             # [G]
    cand = (s.slp[:, None] + logp).reshape(G, R, V)
    eot_sc = cand[:, :, eot].clone()                                   # [G, R]
    cand[:, :, eot] = float("-inf")
    sc, flat = torch.topk(cand.reshape(G, R * V), R, dim=-1)           # [G, R]
    # whisper's update(): sorted candidates route EOT to finished and the
    # rest to live, and stop once R are live, so an EOT is saved iff it
    # outranks the R-th live candidate.
    eot_valid = (eot_sc > sc[:, R - 1:R]) & active_g[:, None]
    ord_sc, ord_idx = torch.topk(
        torch.where(eot_valid, eot_sc, float("-inf")), R, dim=-1)
    valid = ord_sc > float("-inf")
    slots = s.fin_count[:, None] + torch.cumsum(valid.long(), 1) - 1
    keep = valid & (slots < R)
    _beam_store(s, ord_sc, ord_idx, slots, keep)
    s.fin_count.add_(keep.long().sum(1))

    own = torch.arange(B, device=s.prev.device)
    group_base = torch.arange(G, device=own.device)[:, None] * R
    src = torch.where(frozen, own, (flat // V + group_base).reshape(B))
    tok = (flat % V).reshape(B)
    # Reorder every per-beam state to the winners' ancestry, the self-KV
    # cache included (the forward above wrote slot P+step-1 for each
    # current beam, so gathering after it keeps the chosen beams' whole
    # history). Each cache buffer gathers into a temporary and copies back
    # into its fixed address. Cross-KV is per group.
    for layer in s.kv:
        for t in layer.values():
            t.copy_(t.index_select(0, src))
    col = step.reshape(1)
    tokens = s.tokens.index_select(0, src)
    tokens.index_copy_(1, col, torch.where(
        frozen[:, None], tokens.index_select(1, col), tok[:, None]))
    s.tokens.copy_(tokens)
    s.slp.copy_(torch.where(frozen, s.slp, sc.reshape(B)))
    taken_ts = s.last_ts.index_select(0, src)
    if opts.timestamps:
        taken_ts = torch.where(tok >= opts.timestamp_begin, tok, taken_ts)
    s.last_ts.copy_(torch.where(frozen, s.last_ts, taken_ts))
    s.prev2.copy_(torch.where(frozen, s.prev2, s.prev.index_select(0, src)))
    s.prev.copy_(torch.where(frozen, s.prev, tok))
    s.ctl[0].add_(live.long())
    step.add_(1)
    s.ctl[1].copy_(_beam_stop(s, c))


def _beam_steps(s: _BeamState, c: _LoopInputs) -> None:
    """``decode_graph.K`` beam steps: what one beam decode graph captures."""
    for _ in range(decode_graph.K):
        _beam_step(s, c)
    _agree(s.ctl, c.model)


def _finish_beam(s: _BeamState, opts: DecodeOptions):
    """whisper's finalize(): groups short of R finished sequences fill
    their remaining slots from the live beams by cumulative score. Returns
    copies of the store's tokens [B, max_tokens] and scores [B]."""
    R = opts.replicas
    G = s.fin_count.shape[0]
    ord_sc, ord_idx = torch.topk(s.slp.reshape(G, R), R, dim=-1)
    slots = s.fin_count[:, None] + torch.arange(R, device=s.slp.device)
    _beam_store(s, ord_sc, ord_idx, slots, slots < R)
    return (s.fin_tokens[:, :R].reshape(G * R, -1).clone(),
            s.fin_scores[:, :R].reshape(G * R).clone())


@torch.inference_mode()
def beam_decode(
    model: Whisper,
    mel: torch.Tensor,               # [B // replicas, n_mels, T_frames]
    prompt_tokens: torch.Tensor,     # [B, P] left-padded
    prompt_lens: torch.Tensor,       # [B]
    dims: WhisperDims,
    opts: DecodeOptions,
    max_prompt_len: int,
    timer: Optional[StageTimer] = None,
) -> Dict[str, torch.Tensor]:
    """Batched beam search (whisper DecodingOptions(beam_size), patience
    1.0), as the JAX package's ``beam_decode``.

    ``opts.replicas`` = beam width R; mel carries unique rows and prompts /
    outputs carry rows × R with beams consecutive per row, so the beams of
    a row share one encoder forward and one cross-KV stream. Per step
    (``_beam_step``): one decoder forward over all beams, candidate scores
    = cumulative + token logprob, the live set becomes the top-R non-EOT
    candidates over the R×V grid, and the self-KV cache, token history and
    timestamp state gather to the surviving beams' source rows.

    Finished sequences live in a capacity-R store per group: an EOT
    candidate is saved iff it outranks the R-th live candidate,
    score-ordered within a step and first-come across steps, never evicted.
    The loop ends when every group has R finished sequences (or max_tokens
    or the context runs out); a group whose prompt reaches the context end
    freezes in place. Remaining slots then fill from the live beams in
    descending cumulative score, EOT appended at no cost (whisper's
    finalize()). Returns the greedy_decode dict with the R finished
    sequences per row in store order; the caller picks each row's winner by
    sum_logprob / length.

    On a CUDA tensor the loop runs as CUDA graphs of ``decode_graph.K``
    beam steps, one per static key, as greedy_decode's does; on the CPU and
    on a model-sharded rank over gloo the same step runs eagerly."""
    B, P = prompt_tokens.shape
    R = opts.replicas
    if opts.temperature > 0:
        raise ValueError("beam search is temperature-0 only (whisper "
                         "semantics: best_of handles sampling rungs)")
    if P > max_prompt_len:
        raise ValueError(f"prompt slots ({P}) exceed max_prompt_len "
                         f"({max_prompt_len})")
    prompt_tokens = prompt_tokens.long()
    prompt_lens = prompt_lens.long()
    dev = mel.device
    mt = opts.max_tokens
    graphs = decode_graph.graphs_for(model) if _graph_route(model, dev) \
        else None
    with graphs.lock if graphs is not None else contextlib.nullcontext():
        bufs = None
        if graphs is not None:
            bufs = _graph_buffers(graphs, model, mel, B, P,
                                  max_prompt_len + mt, dims, opts, False)
        cross_kv, self_kv, logits, pad, max_len = _prefill(
            model, mel, prompt_tokens, prompt_lens, dims, opts,
            max_prompt_len, timer, spare=decode_graph.K, bufs=bufs)
        no_speech_prob = _no_speech_from_prefill(logits, opts, P)

        with _span(timer, "token_loop"):
            c = _loop_inputs(model, dims, opts, cross_kv, prompt_lens, pad,
                             P, max_len + decode_graph.K, logits.shape[-1],
                             None)
            new_state = functools.partial(_new_beam_state, B, R, mt,
                                          self_kv, dev)
            if bufs is None:
                s = new_state()
            else:
                s, c = _keyed_loop(bufs, c, new_state)
            _start_beam(s, c, logits[:, -1, :])
            if bufs is None:
                loop_steps = _loop_eager(s, c, _beam_step)
            else:
                loop_steps = graphs.run(
                    bufs, functools.partial(_beam_steps, s, c), s.ctl,
                    -(-(mt - 1) // decode_graph.K), timer) if mt > 1 else 0
            fin_tokens, fin_scores = _finish_beam(s, opts)

    if timer is not None:
        timer.count("token_loop_steps", loop_steps)
    out = _finalize_decode(fin_tokens, fin_scores, no_speech_prob, opts)
    out["steps"] = loop_steps + 1    # token positions decoded
    return out


@dataclasses.dataclass
class _VoxtralInputs:
    """What a Voxtral loop step reads and never writes (``_LoopInputs``'
    counterpart): the unique rows' prefix K/V, the prompt's slots, the
    suffix slot index, the suppression mask, t and the generator; and
    ``counts``, which the step fills when it runs eagerly or is captured
    (``voxtral.step_forward``): a graph's replays keep the value of its
    capture, since the key's inputs keep this dict."""

    model: Optional[torch.nn.Module]
    opts: DecodeOptions
    prefix: List[Dict[str, torch.Tensor]]
    P: int                     # prompt positions
    kslot: torch.Tensor        # [M] suffix slot index
    suppress: torch.Tensor     # [V] bool (_suppress_mask)
    temperature: torch.Tensor  # 0-d f32
    generator: Optional[torch.Generator]
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


def _voxtral_step(s: _LoopState, c: _VoxtralInputs) -> None:
    """One token for every row, in place, as ``_greedy_step`` without
    Whisper's rules: the control ids suppressed, EOS ending a row. Past
    the loop's end every row counts as done: such a step writes EOS, adds
    nothing to ``slp`` and leaves ``ctl`` as it was."""
    from clearconverse_tpu_torch.models.voxtral import step_forward
    opts = c.opts
    step = s.step
    live = ~s.finished.all() & (step < opts.max_tokens)
    logits = step_forward(c.model, s.prev, step, c.prefix, s.kv, c.kslot,
                          c.P, opts.compute_dtype, c.counts)
    lg = logits.masked_fill(c.suppress, _NEG_INF)
    logp = F.log_softmax(lg, dim=-1)
    pick = _pick(lg, opts, c.generator, c.temperature)
    done = s.finished | (step >= opts.max_tokens)
    nxt = torch.where(done, opts.eot, pick)
    s.slp.add_(torch.where(done, 0.0, logp.gather(1, pick[:, None])[:, 0]))
    s.tokens.index_copy_(1, step.reshape(1), nxt[:, None])
    s.finished.copy_(done | (nxt == opts.eot))
    s.prev2.copy_(s.prev)
    s.prev.copy_(nxt)
    s.ctl[0].add_(live.long())
    step.add_(1)
    s.ctl[1].copy_(s.finished.all() | (step >= opts.max_tokens))


def _voxtral_steps(s: _LoopState, c: _VoxtralInputs) -> None:
    """``decode_graph.K`` Voxtral steps: what one of its graphs captures."""
    for _ in range(decode_graph.K):
        _voxtral_step(s, c)


def voxtral_counts(U: int, P: int, R: int, steps: int,
                   fused_attn_layers: int = 0) -> Dict[str, int]:
    """What a Voxtral decode call ran: ``prefix_rows`` (unique rows
    prefilled), ``prefix_positions`` (their positions), ``rows``, ``steps``
    (loop steps), ``suffix_positions`` (suffix positions attended, summed
    over rows and steps), ``prefix_copies`` (prefix K/V copies held per
    unique row), ``prefix_reads`` (prefix positions read by the loop,
    summed over its steps) and ``fused_attn_layers`` (the layers of its
    step whose attention ran the kernel, ``ops/decode_attention.py``: every
    layer on the card, 0 on the CPU)."""
    return {"prefix_rows": U, "prefix_positions": U * P, "rows": U * R,
            "steps": steps,
            "suffix_positions": U * R * steps * (steps + 1) // 2,
            "prefix_copies": 1, "prefix_reads": steps * U * P,
            "fused_attn_layers": fused_attn_layers}


@torch.inference_mode()
def voxtral_decode_from_audio(
    model: torch.nn.Module,
    audio: torch.Tensor,             # [U, T] 16 kHz waveform, unique rows
    head: Tuple[int, ...],
    tail: Tuple[int, ...],
    opts: DecodeOptions,
    generator: Optional[torch.Generator] = None,
    target_len: int = 30 * 16000,
    timer: Optional[StageTimer] = None,
) -> Dict[str, Any]:
    """Voxtral's decode (``models/voxtral.py``): pad/trim → log-mel (K1 on
    CUDA) → encoder (K2) → adapter → the prompt (``head`` ids, the audio
    rows, ``tail`` ids) prefilled once per unique row → the token loop over
    ``opts.replicas`` replicas of each row, which share the row's prefix
    K/V. Returns ``greedy_decode``'s dict (``no_speech_prob`` zeros) and
    ``counts`` (``voxtral_counts``). ``timer`` records the spans log_mel,
    encoder, adapter, prefix_prefill and token_loop and counts
    ``token_loop_steps`` and the counters.

    On a CUDA tensor the loop runs as CUDA graphs of ``decode_graph.K``
    steps, one per static key (unique rows, replicas, prompt positions,
    max_tokens, options), the prefix and suffix K/V in the model's arena
    (``DecodeGraphs.prefix_buffers``); on the CPU the same step runs
    eagerly. Beam search is Whisper's: ``opts.beam`` raises."""
    from clearconverse_tpu_torch.audio.mel import log_mel_auto, pad_or_trim
    from clearconverse_tpu_torch.models import voxtral as vx

    if opts.beam:
        raise ValueError("Voxtral decodes greedily or samples best_of; "
                         "beam search is Whisper's")
    dims = model.dims
    cdt = opts.compute_dtype
    dev = audio.device
    R, mt = max(opts.replicas, 1), opts.max_tokens
    with _span(timer, "log_mel"):
        mel = log_mel_auto(pad_or_trim(audio.float(), target_len), dims.n_mels)
    rows = vx.encode_audio(model, mel, cdt,
                           span=lambda name: _span(timer, name))
    x = vx.prompt_embeddings(model, rows, head, tail)
    U, P = x.shape[0], x.shape[1]
    B, M = U * R, mt + decode_graph.K
    graphs = decode_graph.graphs_for(model) if dev.type == "cuda" else None
    with graphs.lock if graphs is not None else contextlib.nullcontext():
        bufs = None
        sampling = opts.temperature > 0 and generator is not None
        if graphs is not None:
            key = ("voxtral", U, R, P, mt, sampling,
                   dataclasses.replace(opts, temperature=float(
                       opts.temperature > 0), suppress_tokens=()))
            layout = decode_graph.PrefixLayout(dims.n_layer, dims.n_kv_head,
                                               dims.head_dim, cdt)
            bufs = graphs.prefix_buffers(key, layout, U, R, P, M,
                                         decode_graph.weights_key(model),
                                         sampling)
        with _span(timer, "prefix_prefill"):
            prefix, last = vx.prefix_prefill(
                model, x, cdt, out=None if bufs is None else bufs.cross_kv)
        suffix = (vx.suffix_cache(dims, U, R, M, cdt, dev) if bufs is None
                  else bufs.self_kv)
        with _span(timer, "token_loop"):
            gen = generator
            if bufs is not None and bufs.generator is not None:
                gen = bufs.generator
                gen.manual_seed(generator.initial_seed())
            c = _VoxtralInputs(
                model, opts, prefix, P, torch.arange(M, device=dev),
                _suppress_mask(opts, dims.n_vocab, dev),
                torch.full((), float(opts.temperature), dtype=torch.float32,
                           device=dev), gen)
            new_state = functools.partial(_new_state, B, M, suffix, dev)
            if bufs is None:
                s = new_state()
            else:
                s, c = _keyed_loop(bufs, c, new_state,
                                   refill=("suppress", "temperature"))
            _start_loop(s, c, last.repeat_interleave(R, dim=0), opts)
            if bufs is None:
                loop_steps = _loop_eager(s, c, _voxtral_step)
            else:
                loop_steps = graphs.run(
                    bufs, functools.partial(_voxtral_steps, s, c), s.ctl,
                    -(-(mt - 1) // decode_graph.K), timer) if mt > 1 else 0
            tokens, slp = s.tokens[:, :mt].clone(), s.slp.clone()

    counts = voxtral_counts(U, P, R, loop_steps,
                            c.counts.get("fused_attn_layers", 0))
    if timer is not None:
        timer.count("token_loop_steps", loop_steps)
        for name in ("prefix_rows", "prefix_positions", "rows",
                     "suffix_positions", "prefix_reads", "fused_attn_layers"):
            timer.count(name, counts[name])
    out = _finalize_decode(tokens, slp, torch.zeros(B, device=dev), opts)
    out["steps"] = loop_steps + 1
    out["counts"] = counts
    return out


@torch.inference_mode()
def detect_language_from_audio(
    model: Whisper,
    audio: torch.Tensor,             # [B, T] 16 kHz waveform
    dims: WhisperDims,
    sot: int,
    lang_lo: int,                    # first language-token id (sot + 1)
    lang_hi: int,                    # one past the last language token
    target_len: int = 30 * 16000,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """whisper detect_language: log-mel (K1 on CUDA), the encoder (K2 on
    CUDA), the cross-KV, one decoder forward over ``[sot]``, and an argmax
    over the language-token logits → [B] language-token ids."""
    from clearconverse_tpu_torch.audio.mel import log_mel_auto, pad_or_trim

    mel = log_mel_auto(pad_or_trim(audio.float(), target_len), dims.n_mels)
    feats = whisper_encode(model, mel, dims, compute_dtype)
    cross_kv = precompute_cross_kv(model, feats, n_head=dims.n_text_head)
    B = mel.shape[0]
    dev = mel.device
    tokens = torch.full((B, 1), sot, dtype=torch.long, device=dev)
    positions = torch.zeros((B, 1), dtype=torch.long, device=dev)
    self_kv = init_kv_cache(dims, B, 1, compute_dtype, device=dev,
                            tp=tensor_parallel(model))
    mask = torch.zeros((1, 1, 1, 1), dtype=torch.float32, device=dev)
    logits, _ = decoder_forward(model, tokens, positions, 0, self_kv,
                                cross_kv, mask, None, dims, compute_dtype)
    lang = logits[:, 0, lang_lo:lang_hi].float()
    return lang.argmax(dim=-1) + lang_lo
