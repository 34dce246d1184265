"""Batched KV-cached Whisper decoding in PyTorch.

The JAX package's models/decoding.py decodes a whole segment batch in one
XLA program. Here the same steps run eagerly on the device: pad/trim,
log-mel (kernel K1 on CUDA), the encoder (kernel K2 on CUDA), head-major
cross-KV, prompt prefill over left-padded prompts, then a Python loop over
a fixed-shape step that advances every sequence one token and stops when
all have emitted EOT. Checking that stop condition reads one flag back
from the device each step. Variable-length prompts keep exact
single-example numerics by giving real tokens their absolute positions and
masking padded cache slots forever.

Prompt layout per row: [sot_prev, ...context_tokens..., sot, (notimestamps)],
left-padded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from clearconverse_tpu_torch.models.whisper import (
    Whisper, WhisperDims, decoder_forward, init_kv_cache, precompute_cross_kv,
    unpack_codes, whisper_encode,
)
from clearconverse_tpu_torch.utils.tracing import StageTimer

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


@functools.lru_cache(maxsize=8)
def _suppress_mask(ids: Tuple[int, ...], vocab: int,
                   device: torch.device) -> torch.Tensor:
    mask = torch.zeros(vocab, dtype=torch.bool)
    mask[list(ids)] = True
    return mask.to(device)


def _suppress(logits: torch.Tensor, opts: DecodeOptions,
              is_first: bool) -> torch.Tensor:
    """Whisper's suppression: the static id set at every step, plus blank
    and EOT on the first sampled token."""
    if opts.suppress_tokens:
        mask = _suppress_mask(opts.suppress_tokens, logits.shape[-1],
                              logits.device)
        logits = logits.masked_fill(mask, _NEG_INF)
    if opts.suppress_blank and is_first:
        logits = logits.clone()
        logits[..., [opts.blank_token, opts.eot]] = _NEG_INF
    return logits


def _timestamp_rules(logits: torch.Tensor, opts: DecodeOptions,
                     is_first: bool, prev: torch.Tensor, prev2: torch.Tensor,
                     last_ts: torch.Tensor, step: int) -> torch.Tensor:
    """whisper ApplyTimestampRules on [B, V] f32 logits. ``prev``/``prev2``
    are the last two sampled tokens (-1 = none); ``last_ts`` is the latest
    sampled timestamp token (-1 = none)."""
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
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy argmax at t = 0; at t > 0 a categorical sample as
    argmax(logits / t + Gumbel noise), the noise drawn from ``generator``
    (not the JAX package's random bits)."""
    if opts.temperature > 0 and generator is not None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return torch.argmax(logits / opts.temperature + gumbel, dim=-1)
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
    """pad/trim + log-mel + decode."""
    from clearconverse_tpu_torch.audio.mel import log_mel_auto, pad_or_trim

    with _span(timer, "log_mel"):
        mel = log_mel_auto(pad_or_trim(audio.float(), target_len), dims.n_mels)
    return greedy_decode(model, mel, prompt_tokens, prompt_lens, dims, opts,
                         max_prompt_len, generator, timer)


def _span(timer: Optional[StageTimer], name: str):
    """``timer``'s span ``name``, or no span when there is no timer."""
    return contextlib.nullcontext() if timer is None else timer.stage(name)


def _widen_codes(ckv: Dict[str, Any], cdt: torch.dtype) -> Dict[str, Any]:
    """int8 or packed int4 cross-KV codes → the compute dtype, once per
    call (int4 unpacked here, with both nibbles sign-extended). |code| <=
    127 is exact in bf16 and f32, so the decode numerics are those of the
    codes; the per-step cast of the JAX version becomes a no-op."""
    return {name: ({"q": unpack_codes(val).to(cdt), "scale": val["scale"]}
                   if isinstance(val, dict) else val)
            for name, val in ckv.items()}


def _prefill(model, mel, prompt_tokens, prompt_lens, dims, opts,
             max_prompt_len, timer: Optional[StageTimer] = None):
    """Encode → cross-KV → prompt prefill. Returns (cross_kv, self_kv,
    prefill logits [B, P, V], pad [B, 1], max_len).

    ``mel`` carries B // opts.replicas unique rows (see DecodeOptions)."""
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
        cross_kv = [_widen_codes(c, cdt) for c in precompute_cross_kv(
            model, audio, n_head=dims.n_text_head, bits=opts.cross_kv_bits)]
    self_kv = init_kv_cache(dims, B, max_len, cdt, bits=opts.self_kv_bits,
                            device=dev)

    pad = (P - prompt_lens)[:, None]                      # [B,1]
    slot = torch.arange(P, device=dev)[None, :]
    positions = torch.clamp(slot - pad, 0, dims.n_text_ctx - 1)

    # Prefill mask: query q sees key k iff k <= q (causal) and k is a real
    # prompt slot. Cache slots >= P are unwritten → hidden.
    kslot = torch.arange(max_len, device=dev)[None, None, None, :]
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
    cross_kv, prefill, token_loop) and counts the loop's steps
    (``token_loop_steps``)."""
    prompt_tokens = prompt_tokens.long()
    prompt_lens = prompt_lens.long()
    B, P = prompt_tokens.shape
    dev = mel.device
    eot = opts.eot
    cross_kv, self_kv, logits, pad, max_len = _prefill(
        model, mel, prompt_tokens, prompt_lens, dims, opts, max_prompt_len,
        timer)
    no_speech_prob = _no_speech_from_prefill(logits, opts, P)

    with _span(timer, "token_loop"):
        first = _suppress(logits[:, -1, :], opts, True)
        none = torch.full((B,), -1, dtype=torch.long, device=dev)
        if opts.timestamps:
            first = _timestamp_rules(first, opts, True, none, none, none, 0)
        logp0 = F.log_softmax(first, dim=-1)
        tok0 = _pick(first, opts, generator)

        tokens = torch.full((B, opts.max_tokens), eot, dtype=torch.long,
                            device=dev)
        tokens[:, 0] = tok0
        finished = tok0 == eot
        slp = logp0.gather(1, tok0[:, None])[:, 0]
        prev, prev2 = tok0, none
        last_ts = (torch.where(tok0 >= opts.timestamp_begin, tok0, none)
                   if opts.timestamps else none)
        kslot = torch.arange(max_len, device=dev)[None, None, None, :]
        padded = kslot < pad[:, None, None, :]            # [B,1,1,max_len]

        step = 1
        while step < opts.max_tokens and not bool(finished.all()):
            # prev = token generated at step-1; its absolute position is
            # prompt_len + step - 1 and its K/V land in cache slot
            # P + step - 1.
            pos = torch.clamp(prompt_lens + step - 1, 0, dims.n_text_ctx - 1)
            mask = torch.where(padded | (kslot > P - 1 + step), _NEG_INF, 0.0)
            logits, self_kv = decoder_forward(
                model, prev[:, None], pos[:, None], P + step - 1, self_kv,
                cross_kv, mask.float(), None, dims, opts.compute_dtype)
            lg = _suppress(logits[:, 0, :], opts, False)
            if opts.timestamps:
                lg = _timestamp_rules(lg, opts, False, prev, prev2, last_ts,
                                      step)
            logp = F.log_softmax(lg, dim=-1)
            nxt = _pick(lg, opts, generator)
            # openai-whisper caps sample_len so prompt+generation <=
            # n_text_ctx; rows whose prompt reaches the context end
            # force-finish.
            done = finished | ((prompt_lens + step) >= dims.n_text_ctx)
            nxt = torch.where(done, eot, nxt)
            slp = slp + torch.where(done, 0.0,
                                    logp.gather(1, nxt[:, None])[:, 0])
            tokens[:, step] = nxt
            finished = done | (nxt == eot)
            if opts.timestamps:
                last_ts = torch.where((nxt >= opts.timestamp_begin) & ~done,
                                      nxt, last_ts)
            prev, prev2 = nxt, prev
            step += 1

    if timer is not None:
        timer.count("token_loop_steps", step - 1)
    out = _finalize_decode(tokens, slp, no_speech_prob, opts)
    out["steps"] = step      # loop steps taken = host syncs on the stop flag
    return out
