"""Plain Whisper in float32, the yardstick that decides ``correct``.

Written from openai-whisper's published model (``whisper/model.py``,
``whisper/audio.py``) in plain PyTorch. It imports nothing of the measured
program: it reads the benchmark's own weight dictionary (``weights.py``,
the same values the program was given) and the audio, prompts and tokens
that the program's decode calls took and produced.

Every product runs in IEEE float32 (TF32 off). ``fp8=True`` rounds both
operands of every product to float8 e4m3 first (tensor-wise scales), the
precision below bf16 that a later change could be tempted by: that mode is
the control that must come out as not correct.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
NEG = -1e9          # the additive mask and the suppression fill
E4M3_MAX = 448.0


@contextlib.contextmanager
def ieee_f32():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    amax), as an fp8 GEMM with tensor-wise scales takes its operands;
    returned in float32."""
    scale = x.abs().amax().clamp_min(1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Ops:
    """The products of the reference, in f32 or with fp8 operands."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return to_fp8(x) if self.fp8 else x

    def linear(self, x, w, b=None):
        y = torch.matmul(self.q(x), self.q(w).T)
        return y if b is None else y + b

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def conv1d(self, x, w, b, stride):
        return F.conv1d(self.q(x), self.q(w), b, stride=stride, padding=1)


# ------------------------------------------------------------------ audio

def mel_filters(n_mels: int, sr: int = SAMPLE_RATE,
                n_fft: int = N_FFT) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels) (slaney scale and area
    norm), as openai-whisper's assets/mel_filters.npz holds it:
    [n_mels, 1 + n_fft // 2]."""
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                        / logstep, f / f_sp)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    fft_hz = np.linspace(0.0, sr / 2, 1 + n_fft // 2)
    edges = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2))
    width = np.diff(edges)
    ramps = edges[:, None] - fft_hz[None, :]
    lower = -ramps[:-2] / width[:-1, None]
    upper = ramps[2:] / width[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (edges[2:n_mels + 2] - edges[:n_mels]))[:, None]
    return w.astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """openai-whisper's log_mel_spectrogram: [B, T] → [B, n_mels, T // 160]."""
    window = torch.hann_window(N_FFT, periodic=True, device=audio.device)
    stft = torch.stft(audio.float(), N_FFT, HOP, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = stft[..., :-1].abs() ** 2
    fb = torch.from_numpy(mel_filters(n_mels)).to(audio.device)
    with ieee_f32():
        mel = torch.matmul(fb, power)
    logs = torch.log10(mel.clamp_min(1e-10))
    logs = torch.maximum(logs, logs.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (logs + 4.0) / 4.0


# ------------------------------------------------------------------ model

def layer_norm(x, w: Dict[str, torch.Tensor], name: str):
    return F.layer_norm(x, (x.shape[-1],), w[f"{name}.weight"],
                        w[f"{name}.bias"], 1e-5)


def _heads(x, n_head):
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def attention(ops: Ops, q, k, v, n_head: int, mask=None):
    """softmax(q k^T / sqrt(d_head) + mask) v over [B, T, D] inputs."""
    qh, kh, vh = _heads(q, n_head), _heads(k, n_head), _heads(v, n_head)
    s = ops.matmul(qh, kh.transpose(-1, -2)) * (qh.shape[-1] ** -0.5)
    if mask is not None:
        s = s + mask
    o = ops.matmul(torch.softmax(s, dim=-1), vh)
    return o.transpose(1, 2).reshape(q.shape[0], q.shape[1], -1)


def _attn_block(ops: Ops, w, p: str, x, kv_src, n_head: int, mask=None):
    q = ops.linear(x, w[f"{p}.q.weight"], w[f"{p}.q.bias"])
    k = ops.linear(kv_src, w[f"{p}.k.weight"])
    v = ops.linear(kv_src, w[f"{p}.v.weight"], w[f"{p}.v.bias"])
    o = attention(ops, q, k, v, n_head, mask)
    return ops.linear(o, w[f"{p}.out.weight"], w[f"{p}.out.bias"])


def _mlp(ops: Ops, w, p: str, x):
    h = F.gelu(ops.linear(x, w[f"{p}.fc1.weight"], w[f"{p}.fc1.bias"]))
    return ops.linear(h, w[f"{p}.fc2.weight"], w[f"{p}.fc2.bias"])


def encode(ops: Ops, w, mel: torch.Tensor, dims) -> torch.Tensor:
    """[B, n_mels, 3000] log-mel → [B, 1500, d] audio features."""
    x = F.gelu(ops.conv1d(mel, w["encoder.conv1.weight"],
                          w["encoder.conv1.bias"], 1))
    x = F.gelu(ops.conv1d(x, w["encoder.conv2.weight"],
                          w["encoder.conv2.bias"], 2))
    x = x.transpose(1, 2) + w["encoder.pos"][: x.shape[2]]
    for i in range(dims["encoder_layers"]):
        p = f"encoder.blocks.{i}"
        h = layer_norm(x, w, f"{p}.attn_ln")
        x = x + _attn_block(ops, w, f"{p}.attn", h, h,
                            dims["encoder_attention_heads"])
        x = x + _mlp(ops, w, f"{p}.mlp", layer_norm(x, w, f"{p}.mlp_ln"))
    return layer_norm(x, w, "encoder.ln_post")


def decode_hidden(ops: Ops, w, tokens, positions, key_mask, audio, dims):
    """Teacher-forced decoder over [B, L] tokens → final hidden [B, L, d].
    ``key_mask`` [B, L] is True at real (not padded) token slots; a query
    sees real keys at or before its own slot."""
    L = tokens.shape[1]
    x = w["decoder.tok"][tokens] + w["decoder.pos"][positions]
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    allowed = causal[None] & key_mask[:, None, :]
    mask = torch.where(allowed, 0.0, NEG)[:, None]
    H = dims["decoder_attention_heads"]
    for i in range(dims["decoder_layers"]):
        p = f"decoder.blocks.{i}"
        h = layer_norm(x, w, f"{p}.attn_ln")
        x = x + _attn_block(ops, w, f"{p}.attn", h, h, H, mask)
        h = layer_norm(x, w, f"{p}.cross_ln")
        x = x + _attn_block(ops, w, f"{p}.cross", h, audio, H)
        x = x + _mlp(ops, w, f"{p}.mlp", layer_norm(x, w, f"{p}.mlp_ln"))
    return layer_norm(x, w, "decoder.ln")


def pad_or_trim(audio: torch.Tensor, n: int) -> torch.Tensor:
    t = audio.shape[-1]
    return audio[..., :n] if t >= n else F.pad(audio, (0, n - t))


@torch.no_grad()
def served_logprob_sums(w, dims, audio, prompts, prompt_lens, tokens,
                        lengths, replicas: int, suppress, blank: int,
                        eot: int, suppress_blank: bool, max_tokens: int,
                        target_len: int, fp8: bool = False,
                        row_block: int = 4) -> np.ndarray:
    """The sum of log-probabilities of each row's served tokens, as the
    reference computes them along those tokens.

    ``audio`` [U, T] holds the call's unique audio rows; ``prompts`` [U*R,
    P] its left-padded prompt tokens with ``prompt_lens``; ``tokens`` [U*R,
    max_tokens] and ``lengths`` what the call served. A row scores its
    tokens up to and including the first EOT (all ``max_tokens`` when it
    has none). The first token is scored with blank and EOT suppressed
    when ``suppress_blank``, and every token with ``suppress`` suppressed:
    the decode's own rules for text without timestamps. Returns [U*R]
    float64."""
    ops = Ops(fp8)
    dev = audio.device
    sup = torch.zeros(dims["vocab_size"], dtype=torch.bool, device=dev)
    if len(suppress):
        sup[torch.as_tensor(list(suppress), device=dev)] = True
    out = np.zeros(prompts.shape[0], np.float64)
    P = prompts.shape[1]
    U = audio.shape[0]
    with ieee_f32():
        for u0 in range(0, U, row_block):
            u1 = min(U, u0 + row_block)
            mel = log_mel(pad_or_trim(audio[u0:u1].float(), target_len),
                          dims["num_mel_bins"])
            feats = encode(ops, w, mel, dims)
            for u in range(u0, u1):
                rows = range(u * replicas, (u + 1) * replicas)
                out[list(rows)] = _score_rows(
                    ops, w, dims, feats[u - u0: u - u0 + 1], prompts,
                    prompt_lens, tokens, lengths, list(rows), sup, blank,
                    eot, suppress_blank, max_tokens, P)
    return out


def _score_rows(ops, w, dims, feat, prompts, prompt_lens, tokens, lengths,
                rows, sup, blank, eot, suppress_blank, max_tokens, P):
    """Scores of the replica rows of one audio row (see
    ``served_logprob_sums``)."""
    dev = feat.device
    n_gen = max_tokens
    L = P + n_gen - 1
    seq = torch.full((len(rows), L), eot, dtype=torch.long, device=dev)
    seq[:, :P] = prompts[rows].long()
    seq[:, P:] = tokens[rows, : n_gen - 1].long()
    pad = (P - prompt_lens[rows].long())[:, None]
    slot = torch.arange(L, device=dev)[None, :]
    key_mask = slot >= pad
    positions = (slot - pad).clamp(0, dims["max_target_positions"] - 1)
    hid = decode_hidden(ops, w, seq, positions, key_mask,
                        feat.expand(len(rows), -1, -1), dims)
    hid = hid[:, P - 1: P - 1 + n_gen]
    logits = ops.matmul(hid, w["decoder.tok"].T)
    logits = logits.masked_fill(sup, NEG)
    if suppress_blank:
        logits[:, 0, [blank, eot]] = NEG
    served = tokens[rows, :n_gen].long()
    n = lengths[rows].long()
    k = torch.arange(n_gen, device=dev)[None, :]
    scored = (k <= torch.clamp(n, max=n_gen - 1)[:, None]).cpu().numpy()
    lp = torch.log_softmax(logits, dim=-1).gather(2, served[..., None])[..., 0]
    return (lp.double().cpu().numpy() * scored).sum(axis=1)
