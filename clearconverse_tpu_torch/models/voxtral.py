"""Voxtral Mini 3B (Mistral AI, ``mistralai/Voxtral-Mini-3B-2507``) as a
transcriber: Whisper large-v3's encoder, a 4-frame adapter and a 30-layer
grouped-query decoder.

Equations, as the published ``config.json`` and HF's ``VoxtralForConditional
Generation`` lay them out:

* **Audio tower.** Whisper large-v3's encoder, whole (128 mels, 30 s
  windows, the conv stem, 32 pre-LN layers at d 1280, 20 heads of 64, FFN
  5120, sinusoidal positions, a final LN). It is the port's Whisper encoder
  (``whisper._Encoder``, run by ``whisper.whisper_encode``), so K1 and K2
  run it on the card as for large-v3-turbo. No Whisper decoder is made.
* **Adapter.** The encoder's 1500 frames become 375 rows of 4 consecutive
  frames (5120 wide); ``linear_1`` (5120 → 3072, no bias), GELU (erf),
  ``linear_2`` (3072 → 3072, no bias).
* **Decoder.** 30 pre-norm layers at d 3072: RMSNorm (eps 1e-5, weight
  times the normalised f32 value); attention with 32 query heads and 8 K/V
  heads of 128 (each K/V head serves 4 query heads), the 4096-wide output
  projected back to 3072; RoPE with θ 1e8 on q and k at every prompt
  position, audio positions included; the SwiGLU MLP ``down(silu(gate(x)) ·
  up(x))`` at 8192; no biases; a final RMSNorm and an untied ``lm_head``
  over 131,072 ids.
* **Prompt.** A 30 s window's prompt is ``<s>[INST][BEGIN_AUDIO]``, the
  adapter's 375 rows in the places of 375 ``[AUDIO]`` ids, then
  ``[/INST]lang:en[TRANSCRIBE]`` (``models/tokenizer.TekkenSpecials``).

Precision as published (``torch_dtype`` bfloat16): bf16 weights and matmul
operands; RMSNorm, softmax, the residual stream, RoPE's rotation and the
attention and vocabulary logits in f32 (``whisper.matmul_f32``); K/V held in
bf16. The encoder keeps Whisper's rules (``whisper_encode``).

best_of's replicas share one prompt, so the prompt is prefilled once per
unique row (``prefix_prefill``) and its K/V held once; a loop step
(``step_forward``) attends each replica to that prefix (each prefix read
once per step for all R) and to its own generated suffix. On the card a
layer's step attention is one hand-written kernel
(``ops/decode_attention.py``), which reads K position-major (``[rows, 8, P,
128]``, as V); on the CPU its plain version runs the products on K's
head-major storage (``[rows, 8, 128, P]``, as Whisper's decode holds it).

Departures from the published model (each also under the configuration's
``assumed``):

* The Tekken special ids (``TekkenSpecials``) are the ones Mistral's
  transcription template uses as far as the published files show; the
  released ``tekken.json`` is not read here, so ``lang:en`` goes in as its
  bytes (ids 1000 + byte) and generated ids are decoded from their bytes.
* RoPE is HF's rotate-half layout (q and k projections as HF's conversion
  permutes them), not Mistral's interleaved one.
* ``lm_head`` is a weight of its own (the published config does not tie it).
* ``condition_on_previous_text``'s prompt is dropped: the transcription
  template has no slot for earlier text.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from clearconverse_tpu_torch.models.whisper import (
    WhisperDims, _Encoder, matmul_f32, sinusoids, whisper_encode)
from clearconverse_tpu_torch.ops.decode_attention import decode_attention

# The published name ``Config.whisper_model_size`` selects it by.
NAME = "voxtral-mini-3b-2507"

_NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class VoxtralDims:
    """The published widths (``config.json``: ``audio_config``,
    ``text_config`` and the projector)."""

    n_mels: int = 128
    n_audio_ctx: int = 1500
    n_audio_state: int = 1280
    n_audio_head: int = 20
    n_audio_layer: int = 32
    stack: int = 4                  # encoder frames per adapter row
    d_model: int = 3072
    n_layer: int = 30
    n_head: int = 32
    n_kv_head: int = 8
    head_dim: int = 128
    d_ffn: int = 8192
    n_vocab: int = 131072
    rope_theta: float = 1e8
    rms_eps: float = 1e-5

    @property
    def audio(self) -> WhisperDims:
        """The audio tower's widths as the port's Whisper encoder reads
        them (its decoder fields are unused)."""
        return WhisperDims(n_mels=self.n_mels, n_audio_ctx=self.n_audio_ctx,
                           n_audio_state=self.n_audio_state,
                           n_audio_head=self.n_audio_head,
                           n_audio_layer=self.n_audio_layer, n_text_layer=0)

    @property
    def audio_rows(self) -> int:
        """Adapter rows of one 30 s window (375)."""
        return self.n_audio_ctx // self.stack

    @property
    def kv_width(self) -> int:
        return self.n_kv_head * self.head_dim


# name → the widths the bundle builds, as ``resepformer.SEPARATORS``.
VOXTRALS = {NAME: VoxtralDims()}


def is_voxtral(name: str) -> bool:
    return name in VOXTRALS


# ------------------------------------------------------------------ module

class _RMSNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))


class _Attention(nn.Module):
    def __init__(self, dims: VoxtralDims):
        super().__init__()
        d, q = dims.d_model, dims.n_head * dims.head_dim
        self.q = nn.Linear(d, q, bias=False)
        self.k = nn.Linear(d, dims.kv_width, bias=False)
        self.v = nn.Linear(d, dims.kv_width, bias=False)
        self.o = nn.Linear(q, d, bias=False)


class _MLP(nn.Module):
    def __init__(self, d: int, f: int):
        super().__init__()
        self.gate = nn.Linear(d, f, bias=False)
        self.up = nn.Linear(d, f, bias=False)
        self.down = nn.Linear(f, d, bias=False)


class _Layer(nn.Module):
    def __init__(self, dims: VoxtralDims):
        super().__init__()
        self.attn_norm = _RMSNorm(dims.d_model)
        self.attn = _Attention(dims)
        self.mlp_norm = _RMSNorm(dims.d_model)
        self.mlp = _MLP(dims.d_model, dims.d_ffn)


class _Adapter(nn.Module):
    def __init__(self, dims: VoxtralDims):
        super().__init__()
        self.linear_1 = nn.Linear(dims.stack * dims.n_audio_state,
                                  dims.d_model, bias=False)
        self.linear_2 = nn.Linear(dims.d_model, dims.d_model, bias=False)


class _Decoder(nn.Module):
    def __init__(self, dims: VoxtralDims):
        super().__init__()
        self.tok = nn.Parameter(torch.empty(dims.n_vocab, dims.d_model))
        self.layers = nn.ModuleList(_Layer(dims) for _ in range(dims.n_layer))
        self.norm = _RMSNorm(dims.d_model)
        self.lm_head = nn.Linear(dims.d_model, dims.n_vocab, bias=False)


class Voxtral(nn.Module):
    """Parameter container: ``encoder`` (Whisper's, ``whisper._Encoder``),
    ``adapter``, ``decoder``. Matmul weights, embeddings and the encoder's
    biases and positions in the compute dtype; layer norms and RMSNorm
    weights in f32."""

    def __init__(self, dims: VoxtralDims):
        super().__init__()
        self.dims = dims
        self.encoder = _Encoder(dims.audio)
        self.adapter = _Adapter(dims)
        self.decoder = _Decoder(dims)


def empty_voxtral(dims: VoxtralDims, device,
                  dtype: torch.dtype = torch.bfloat16) -> Voxtral:
    """An uninitialised inference-only Voxtral on ``device``, built on the
    meta device first."""
    with torch.device("meta"):
        model = Voxtral(dims)
    model = model.to_empty(device=device).requires_grad_(False).to(dtype)
    for m in model.modules():
        if isinstance(m, (nn.LayerNorm, _RMSNorm)):
            m.float()
    return model.eval()


@torch.no_grad()
def init_voxtral(dims: VoxtralDims, seed: int = 0, device="cuda",
                 dtype: torch.dtype = torch.bfloat16) -> Voxtral:
    """Seeded random init: normal weights scaled by fan-in^-0.5, zero
    biases, unit norms, embeddings std d^-0.5, the encoder's sinusoid
    table."""
    model = empty_voxtral(dims, device, dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.LayerNorm, _RMSNorm)):
            m.weight.fill_(1.0)
        elif isinstance(m, (nn.Linear, nn.Conv1d)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen,
                                       device=device)
                           * m.weight[0].numel() ** -0.5)
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()
    model.encoder.pos.copy_(torch.from_numpy(
        sinusoids(*model.encoder.pos.shape)))
    model.decoder.tok.copy_(torch.randn(model.decoder.tok.shape, generator=gen,
                                        device=device) * dims.d_model ** -0.5)
    return model


# ------------------------------------------------------------------ ops

def rms_norm(x: torch.Tensor, norm: _RMSNorm, eps: float) -> torch.Tensor:
    """HF's RMSNorm in f32: the weight times x / rms(x)."""
    x = x.float()
    return norm.weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                                          + eps))


def rope_tables(dims: VoxtralDims, positions: torch.Tensor):
    """cos, sin [..., head_dim] f32 at ``positions`` (any shape): HF's
    rotate-half layout, the frequencies repeated over both halves."""
    inv = 1.0 / (dims.rope_theta ** (torch.arange(
        0, dims.head_dim, 2, device=positions.device).float()
        / dims.head_dim))
    ang = positions.float()[..., None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x · cos + rotate_half(x) · sin in f32, rounded back to x's dtype."""
    x32 = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * cos + rot * sin).to(x.dtype)


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, lin.weight.to(x.dtype))


def _mlp(h: torch.Tensor, mlp: _MLP) -> torch.Tensor:
    return _linear(F.silu(_linear(h, mlp.gate)) * _linear(h, mlp.up),
                   mlp.down)


def _logits(model: Voxtral, x: torch.Tensor, cdt) -> torch.Tensor:
    """Final RMSNorm → ``lm_head`` → f32 logits."""
    dims = model.dims
    h = rms_norm(x, model.decoder.norm, dims.rms_eps).to(cdt)
    return matmul_f32(h, model.decoder.lm_head.weight.to(cdt).T)


# ------------------------------------------------------------------ audio

def encode_audio(model: Voxtral, mel: torch.Tensor,
                 cdt: torch.dtype = torch.bfloat16,
                 span=None) -> torch.Tensor:
    """[U, n_mels, 3000] log-mel → the adapter's [U, 375, d_model] rows:
    the Whisper encoder (K2 on the card), then the 4-frame stack and the
    adapter. ``span(name)`` opens the stage spans ``encoder`` and
    ``adapter`` when given."""
    dims = model.dims
    with _maybe(span, "encoder"):
        feats = whisper_encode(model, mel, dims.audio, cdt)
    with _maybe(span, "adapter"):
        return adapter(model, feats)


def adapter(model: Voxtral, feats: torch.Tensor) -> torch.Tensor:
    """[U, 1500, 1280] encoder frames → [U, 375, d_model]: 4 consecutive
    frames a row, ``linear_2(gelu(linear_1(row)))``."""
    dims = model.dims
    U, T, D = feats.shape
    rows = feats.reshape(U, T // dims.stack, dims.stack * D)
    h = F.gelu(_linear(rows, model.adapter.linear_1))
    return _linear(h, model.adapter.linear_2)


def _maybe(span, name: str):
    return span(name) if span is not None else contextlib.nullcontext()


# ------------------------------------------------------------------ prompt

def prompt_embeddings(model: Voxtral, audio_rows: torch.Tensor,
                      head: Sequence[int], tail: Sequence[int]
                      ) -> torch.Tensor:
    """[U, P, d_model] f32: the embeddings of the ``head`` ids, the audio
    rows in the places of the ``[AUDIO]`` ids, and the ``tail`` ids."""
    U = audio_rows.shape[0]
    dev = audio_rows.device
    tok = model.decoder.tok

    def emb(ids):
        t = torch.as_tensor(list(ids), dtype=torch.long, device=dev)
        return tok[t].float()[None].expand(U, -1, -1)

    return torch.cat([emb(head), audio_rows.float(), emb(tail)], dim=1)


# ------------------------------------------------------------------ prefill

def _split_q(q: torch.Tensor, dims: VoxtralDims) -> torch.Tensor:
    """[..., n_head, head_dim] → [..., n_kv_head, group, head_dim]."""
    g = dims.n_head // dims.n_kv_head
    return q.reshape(*q.shape[:-2], dims.n_kv_head, g, dims.head_dim)


@torch.inference_mode()
def prefix_prefill(model: Voxtral, x: torch.Tensor,
                   cdt: torch.dtype = torch.bfloat16,
                   out: Optional[List[Dict[str, torch.Tensor]]] = None):
    """The prompt of each unique row, once: ``x`` [U, P, d_model] (f32
    embeddings, ``prompt_embeddings``) through every layer with causal
    self-attention. Returns (per-layer K/V ``{"k", "v"}`` each [U, n_kv,
    P, head_dim] in the compute dtype, the last position's f32 logits [U,
    vocab]). ``out``, when given (one ``{"k", "v"}`` a layer, each [U,
    n_kv, P, head_dim]: a decode graph's prefix buffers, position-major as
    the step's kernel reads them), receives K/V with ``copy_`` and is
    returned; without it ``"k"`` is the transposed view of the head-major K
    that the products read."""
    dims = model.dims
    U, P, _ = x.shape
    dev = x.device
    H, dh = dims.n_kv_head, dims.head_dim
    g = dims.n_head // H
    cos, sin = rope_tables(dims, torch.arange(P, device=dev))
    cos, sin = cos[:, None], sin[:, None]                 # [P, 1, dh]
    qpos = torch.arange(g * P, device=dev) % P
    causal = torch.where(torch.arange(P, device=dev)[None, :]
                         <= qpos[:, None], 0.0, _NEG_INF)  # [gP, P]
    scale = dh ** -0.5
    kv = []
    for i, layer in enumerate(model.decoder.layers):
        h = rms_norm(x, layer.attn_norm, dims.rms_eps).to(cdt)
        q = apply_rope(_linear(h, layer.attn.q).view(U, P, dims.n_head, dh),
                       cos, sin)
        k = apply_rope(_linear(h, layer.attn.k).view(U, P, H, dh), cos, sin)
        v = _linear(h, layer.attn.v).view(U, P, H, dh)
        kt = k.permute(0, 2, 3, 1).contiguous()           # [U, H, dh, P]
        vh = v.transpose(1, 2)                            # [U, H, P, dh]
        if out is None:
            vh = vh.contiguous()
            kv.append({"k": kt.transpose(2, 3), "v": vh})
        else:
            out[i]["k"].copy_(k.transpose(1, 2))
            out[i]["v"].copy_(vh)
            vh = out[i]["v"]
            kv.append(out[i])
        # [U, P, H, g, dh] → [U, H, g * P, dh]: a head's group rows stacked.
        qh = _split_q(q, dims).permute(0, 2, 3, 1, 4).reshape(U, H, g * P, dh)
        logits = matmul_f32(qh, kt) * scale + causal
        w = torch.softmax(logits, dim=-1).to(cdt)
        o = matmul_f32(w, vh).to(cdt)                     # [U, H, gP, dh]
        o = o.view(U, H, g, P, dh).permute(0, 3, 1, 2, 4).reshape(U, P, -1)
        x = x + _linear(o, layer.attn.o).float()
        h = rms_norm(x, layer.mlp_norm, dims.rms_eps).to(cdt)
        x = x + _mlp(h, layer.mlp).float()
    return kv, _logits(model, x[:, -1], cdt)


# ------------------------------------------------------------------ step

def step_forward(model: Voxtral, prev: torch.Tensor, step: torch.Tensor,
                 prefix: List[Dict[str, torch.Tensor]],
                 suffix: List[Dict[str, torch.Tensor]], kslot: torch.Tensor,
                 P: int, cdt: torch.dtype = torch.bfloat16,
                 counts: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """One token for each of the B = U·R rows (R replicas of each unique
    row consecutive): ``prev`` [B], the token sampled at loop step
    ``step`` - 1 (a 0-d device tensor), sits at position P + step - 1 and
    its K/V land in suffix slot step - 1.

    ``prefix`` holds the unique rows' prompt K/V once (``{"k": [U, n_kv,
    P, dh], "v": ...}``); ``suffix`` each row's own cache, ``{"k": [U,
    n_kv, R, M, dh], "v": ...}``, written in place. Each layer's attention
    is ``ops/decode_attention.decode_attention``: on the card one kernel
    that reads each prefix once for all replicas and each suffix up to
    ``step`` only; on the CPU its plain version, which folds the R replicas
    and a K/V head's query group into one query axis against the prefix.
    ``kslot`` [M] is the slot index. ``counts``, when given, receives
    ``fused_attn_layers``: the layers whose attention ran the kernel.
    Returns f32 logits [B, vocab]. Reads nothing from the host, so the
    decode's token loop captures it into a CUDA graph."""
    dims = model.dims
    cos, sin = rope_tables(dims, step + (P - 1))          # [dh]
    launches = decode_attention.launches
    x = model.decoder.tok[prev].float()
    for layer, pre, suf in zip(model.decoder.layers, prefix, suffix):
        h = rms_norm(x, layer.attn_norm, dims.rms_eps).to(cdt)
        o = decode_attention(_linear(h, layer.attn.q), _linear(h, layer.attn.k),
                             _linear(h, layer.attn.v), cos, sin, step, pre,
                             suf, kslot)
        x = x + _linear(o, layer.attn.o).float()
        h = rms_norm(x, layer.mlp_norm, dims.rms_eps).to(cdt)
        x = x + _mlp(h, layer.mlp).float()
    if counts is not None:
        counts["fused_attn_layers"] = decode_attention.launches - launches
    return _logits(model, x, cdt)


def suffix_cache(dims: VoxtralDims, U: int, R: int, M: int, dtype,
                 device) -> List[Dict[str, torch.Tensor]]:
    """Zeroed per-layer suffix caches ``{"k", "v"}``, each [U, n_kv, R, M,
    dh], for the eager (CPU) route: K's storage is head-major (``"k"`` a
    transposed view of [U, n_kv, R, dh, M]), as the plain version's
    products read it. The card's live in a decode graph's arena,
    position-major (``decode_graph._PrefixArena``)."""
    H, dh = dims.n_kv_head, dims.head_dim
    return [{"k": torch.zeros((U, H, R, dh, M), dtype=dtype,
                              device=device).transpose(3, 4),
             "v": torch.zeros((U, H, R, M, dh), dtype=dtype, device=device)}
            for _ in range(dims.n_layer)]
