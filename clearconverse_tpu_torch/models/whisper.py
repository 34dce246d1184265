"""Whisper encoder-decoder in PyTorch.

Architecture parity target: openai-whisper's ``model.py``, as the JAX
package's models/whisper.py implements it. ``Whisper`` is an ``nn.Module``
whose parameters mirror the JAX package's param pytree names (encoder
conv1/conv2/pos/blocks[i]{attn_ln, attn{q,k,v,out}, mlp_ln, mlp{fc1,fc2}}/
ln_post; decoder tok/pos/blocks[i]{…, cross_ln, cross}/ln), in PyTorch's
own layouts (``nn.Linear`` weights are ``[out, in]``, ``nn.Conv1d``
weights ``[Cout, Cin, k]``). The forward passes are plain functions over
that module, named after their JAX counterparts.

Matmul weights live in the compute dtype chosen at load (bf16 by default);
layer norms run in f32. Attention uses whisper's (d_head)^-0.25 scaling on
both q and k. On CUDA with 64-wide heads the encoder's self-attention is the
hand-written kernel K2 (ops/encoder_attention.py).

Rounding in the decoder follows the JAX package at a 16-bit compute dtype:
products of compute-dtype operands accumulate in f32, and the attention
logits and the vocabulary logits stay f32 (``matmul_f32``, the JAX
``preferred_element_type=jnp.float32``); attention scales are rounded to
the compute dtype first (``_in_dtype``). The residual stream stays f32: the
JAX package rounds each residual sum to bf16 in its source, but XLA's
default excess precision keeps it in f32 inside a fusion, and on a seeded
tiny model that elided rounding is most of the gap between a bf16 and an
f32 transcript (ROADMAP F3). At f32 none of this changes a bit.

A tensor-parallel shard (``parallel/sharding.shard_whisper``) carries its
context as ``model.tp``: the forward passes then attend with the rank's
local heads and run Megatron's two collectives around the sharded layers;
``model.tp`` is absent on a whole model. A decoder quantized by
``ops/quantize.quantize_whisper_decoder`` holds int8 linears, which
``dense`` dispatches on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clearconverse_tpu_torch.utils.precision import full_f32


@dataclasses.dataclass(frozen=True)
class WhisperDims:
    """Model hyperparameters (openai ModelDimensions)."""

    n_mels: int = 80
    n_vocab: int = 51864
    n_audio_ctx: int = 1500
    n_audio_state: int = 768
    n_audio_head: int = 12
    n_audio_layer: int = 12
    n_text_ctx: int = 448
    n_text_state: int = 768
    n_text_head: int = 12
    n_text_layer: int = 12

    @property
    def head_dim(self) -> int:
        return self.n_text_state // self.n_text_head


# name → (state, heads, encoder layers, decoder layers): the openai-whisper
# family. English-only (.en) models use the 51864 vocab.
_SIZES = {
    "tiny": (384, 6, 4, 4), "base": (512, 8, 6, 6),
    "small": (768, 12, 12, 12), "medium": (1024, 16, 24, 24),
    "large": (1280, 20, 32, 32), "large-v1": (1280, 20, 32, 32),
    "large-v2": (1280, 20, 32, 32), "large-v3": (1280, 20, 32, 32),
    "turbo": (1280, 20, 32, 4), "large-v3-turbo": (1280, 20, 32, 4),
}
# large-v3 family: 128-bin mel frontend and one extra vocab entry.
_V3 = ("large-v3", "turbo", "large-v3-turbo")


def model_dims(name: str) -> WhisperDims:
    english = name.endswith(".en")
    size = name[:-3] if english else name
    if size not in _SIZES:
        raise ValueError(f"unknown whisper model {name!r}")
    d, h, enc_l, dec_l = _SIZES[size]
    if english:
        n_vocab = 51864
    else:
        n_vocab = 51866 if size in _V3 else 51865
    return WhisperDims(
        n_mels=128 if size in _V3 else 80,
        n_vocab=n_vocab,
        n_audio_state=d, n_audio_head=h, n_audio_layer=enc_l,
        n_text_state=d, n_text_head=h, n_text_layer=dec_l,
    )


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """openai whisper's fixed encoder positional table."""
    inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


# ------------------------------------------------------------------ module

class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(d, d, bias=False)
        self.v = nn.Linear(d, d)
        self.out = nn.Linear(d, d)


class _MLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.fc1 = nn.Linear(d, 4 * d)
        self.fc2 = nn.Linear(4 * d, d)


class _Block(nn.Module):
    def __init__(self, d: int, cross: bool):
        super().__init__()
        self.attn_ln = nn.LayerNorm(d)
        self.attn = _Attention(d)
        self.mlp_ln = nn.LayerNorm(d)
        self.mlp = _MLP(d)
        if cross:
            self.cross_ln = nn.LayerNorm(d)
            self.cross = _Attention(d)


class _Encoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims.n_audio_state
        self.conv1 = nn.Conv1d(dims.n_mels, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.pos = nn.Parameter(torch.empty(dims.n_audio_ctx, d))
        self.blocks = nn.ModuleList(_Block(d, cross=False)
                                    for _ in range(dims.n_audio_layer))
        self.ln_post = nn.LayerNorm(d)


class _Decoder(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        d = dims.n_text_state
        self.tok = nn.Parameter(torch.empty(dims.n_vocab, d))
        self.pos = nn.Parameter(torch.empty(dims.n_text_ctx, d))
        self.blocks = nn.ModuleList(_Block(d, cross=True)
                                    for _ in range(dims.n_text_layer))
        self.ln = nn.LayerNorm(d)


class Whisper(nn.Module):
    """Parameter container; see the module docstring for the layout."""

    def __init__(self, dims: WhisperDims):
        super().__init__()
        self.dims = dims
        self.encoder = _Encoder(dims)
        self.decoder = _Decoder(dims)


def empty_whisper(dims: WhisperDims, device, dtype=torch.float32) -> Whisper:
    """An uninitialised inference-only Whisper on ``device``: matmul weights,
    embeddings and biases in ``dtype``, layer norms in f32. Built on the meta
    device first, so no memory is touched twice."""
    with torch.device("meta"):
        model = Whisper(dims)
    model = model.to_empty(device=device).requires_grad_(False).to(dtype)
    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            m.float()
    return model.eval()


# ------------------------------------------------------------------ ops

def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, eps: float = 1e-5) -> torch.Tensor:
    out = F.layer_norm(x.float(), (x.shape[-1],), ln.weight, ln.bias, eps)
    return out.to(x.dtype)


def dense(x: torch.Tensor, lin: nn.Module, bias: bool = True) -> torch.Tensor:
    """``x @ W^T + b`` in ``x``'s dtype; ``bias=False`` leaves ``b`` out.
    An int8 linear (``ops/quantize.QuantizedLinear``) goes to
    ``dense_quantized``."""
    if hasattr(lin, "wq"):
        from clearconverse_tpu_torch.ops.quantize import dense_quantized
        return dense_quantized(x, lin, bias=bias)
    b = None if lin.bias is None or not bias else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), b)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32: the products of two compute-dtype operands summed in
    f32 and never rounded to the compute dtype, as the JAX package's
    ``preferred_element_type=jnp.float32``. A bf16 product is exact in f32,
    so the plain version multiplies the operands widened to f32: on the CPU,
    and wherever autograd must see the product (the train step). On the
    card cuBLAS takes the 16-bit operands and writes f32 (``out_dtype``);
    ``b`` is 2-D or has ``a``'s leading axes."""
    if (a.dtype == torch.float32 or not a.is_cuda
            or (torch.is_grad_enabled()
                and (a.requires_grad or b.requires_grad))):
        return torch.matmul(a.float(), b.float())
    m, n = a.shape[-2], b.shape[-1]
    if b.dim() == 2:
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.view(*a.shape[:-1], n)
    y = torch.bmm(a.reshape(-1, m, a.shape[-1]),
                  b.reshape(-1, b.shape[-2], n), out_dtype=torch.float32)
    return y.view(*a.shape[:-2], m, n)


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (f32 or bf16, to nearest even): a
    scale the JAX package casts to the operand's dtype before it multiplies
    (``jnp.asarray(s, x.dtype)``). Host arithmetic only, so a captured
    decode step may call it."""
    x = np.float32(value)
    if dtype == torch.bfloat16:
        bits = int(x.view(np.uint32))
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
        x = np.uint32(bits).view(np.float32)
    elif dtype != torch.float32:
        raise ValueError(f"compute dtype must be f32 or bf16, got {dtype}")
    return float(x)


def tensor_parallel(model: nn.Module):
    """A shard's tensor-parallel context (``parallel/sharding``), or None."""
    return getattr(model, "tp", None)


def _column(x: torch.Tensor, lins, tp,
            n_head: Optional[int] = None) -> List[torch.Tensor]:
    """Column-parallel projections of one input: under tensor parallelism
    the input passes Megatron's f first, and when the ``n_head`` heads of an
    attention's q, k or v do not split over the model axis the outputs are
    gathered into whole heads."""
    if tp is None:
        return [dense(x, lin) for lin in lins]
    x = tp.enter(x)
    outs = [dense(x, lin) for lin in lins]
    if n_head is None or tp.splits(n_head):
        return outs
    return [tp.gather(y) for y in outs]


def _row(h: torch.Tensor, lin: nn.Module, tp,
         n_head: Optional[int] = None) -> torch.Tensor:
    """A row-parallel projection: under tensor parallelism the partial
    product is summed over the model axis (Megatron's g) before the bias,
    which is added once. ``n_head`` names the heads of an attention output
    that was computed whole (not split): each rank takes its own block."""
    if tp is None:
        return dense(h, lin)
    if n_head is not None and not tp.splits(n_head):
        h = tp.local_columns(h)
    y = tp.reduce(dense(h, lin, bias=False))
    return y if lin.bias is None else y + lin.bias.to(y.dtype)


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor], n_head: int) -> torch.Tensor:
    """q:[B,Tq,D] k,v:[B,Tk,D] bias:[B,1,Tq,Tk] additive (f32) → [B,Tq,D].

    Whisper scaling: q and k each scaled by head_dim**-0.25 in their own
    dtype; products accumulate in f32, as the JAX einsums do."""
    d_head = q.shape[-1] // n_head
    scale = d_head ** -0.25
    qh = (_split_heads(q, n_head) * scale).float()
    kh = (_split_heads(k, n_head) * scale).float()
    vh = _split_heads(v, n_head).float()
    with full_f32():
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
        if bias is not None:
            logits = logits + bias
        w = torch.softmax(logits, dim=-1).to(q.dtype).float()
        out = torch.einsum("bhqk,bkhd->bqhd", w, vh)
    return out.reshape(q.shape).to(q.dtype)


def _mlp(x: torch.Tensor, mlp: _MLP, tp=None) -> torch.Tensor:
    h, = _column(x, [mlp.fc1], tp)
    return _row(F.gelu(h), mlp.fc2, tp)


# ------------------------------------------------------------------ encoder

def whisper_encode(model: Whisper, mel: torch.Tensor, dims: WhisperDims,
                   compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, n_mels, T_frames] log-mel → [B, T_frames//2, d] audio features.

    The self-attention is ``encoder_attention`` (kernel K2): its plain
    version for CPU tensors, the kernel for CUDA tensors, which raises for
    heads that are not 64 wide. On a tensor-parallel shard it runs with the
    rank's local heads."""
    from clearconverse_tpu_torch.ops.encoder_attention import encoder_attention

    enc = model.encoder
    cdt = compute_dtype
    tp = tensor_parallel(model)
    H = dims.n_audio_head
    heads = H if tp is None else tp.heads(H)
    x = mel.to(cdt)
    with full_f32():   # cuDNN convolutions default to TF32 in f32
        x = F.gelu(F.conv1d(x, enc.conv1.weight.to(cdt),
                            enc.conv1.bias.to(cdt), padding=1))
        x = F.gelu(F.conv1d(x, enc.conv2.weight.to(cdt),
                            enc.conv2.bias.to(cdt), stride=2, padding=1))
    x = (x.transpose(1, 2) + enc.pos[: x.shape[2]].to(cdt)).contiguous()
    for blk in enc.blocks:
        h = layer_norm(x, blk.attn_ln)
        q, k, v = _column(h, [blk.attn.q, blk.attn.k, blk.attn.v], tp, H)
        h = encoder_attention(q, k, v, heads)
        x = x + _row(h, blk.attn.out, tp, H)
        x = x + _mlp(layer_norm(x, blk.mlp_ln), blk.mlp, tp)
    return layer_norm(x, enc.ln_post)


# ------------------------------------------------------------------ decoder

def precompute_cross_kv(model: Whisper, audio: torch.Tensor, n_head: int,
                        bits: int = 16, out: Optional[List[Dict[str, Any]]] = None
                        ) -> List[Dict[str, Any]]:
    """Per-layer cross-attention K/V from the encoder output, computed once
    per segment and re-read every decode step, in the head-major decode
    layout: K [B, H, dh, T], V [B, H, T, dh]. ``bits`` is 16, 8 or 4: 8 and
    4 store integer codes with per-channel f32 scales (amax over T); int4
    codes are packed two a byte along the last axis (``_quant_kv``).
    ``n_head`` is the model's; a tensor-parallel shard keeps its local
    heads.

    ``out``, when given, holds one destination per layer in the widened
    decode layout (``{"kt", "vt"}`` at 16 bits, ``{"k8t": {"q", "scale"},
    "v8t": ...}`` with the codes in the compute dtype at 8 and 4 bits):
    each layer is written into it with ``copy_`` as it is computed, so no
    second copy of the whole cross-KV is held, and ``out`` is returned."""
    if bits not in (16, 8, 4):
        raise ValueError(f"cross-KV width must be 16, 8 or 4, got {bits}")
    tp = tensor_parallel(model)
    if out is None:
        return [_head_major_kv_direct(audio, blk.cross, n_head, bits, tp)
                for blk in model.decoder.blocks]
    for blk, dst in zip(model.decoder.blocks, out):
        _head_major_kv_direct(audio, blk.cross, n_head, bits, tp, dst)
    return out


def _head_major_kv_direct(audio: torch.Tensor, cross: _Attention,
                          n_head: int, bits: int, tp=None,
                          out: Optional[Dict[str, Any]] = None
                          ) -> Dict[str, Any]:
    """Project K/V and lay them out head-major: [B,H,dh,T] / [B,H,T,dh];
    with ``out``, write them (widened codes and scales when quantized) into
    that layer destination instead (see ``precompute_cross_kv``)."""
    B, T, D = audio.shape
    dh = D // n_head
    heads = n_head if tp is None else tp.heads(n_head)
    k, v = _column(audio, [cross.k, cross.v], tp, n_head)
    kt = k.view(B, T, heads, dh).permute(0, 2, 3, 1)
    vt = v.view(B, T, heads, dh).permute(0, 2, 1, 3)
    if out is not None and bits == 16:
        out["kt"].copy_(kt)
        out["vt"].copy_(vt)
        return out
    kt, vt = kt.contiguous(), vt.contiguous()
    if bits in (8, 4):
        res = {"k8t": _quant_kv(kt, bits, axis=-1),
               "v8t": _quant_kv(vt, bits, axis=-2)}
        if out is not None:
            for name in ("k8t", "v8t"):
                out[name]["q"].copy_(unpack_codes(res[name]))
                out[name]["scale"].copy_(res[name]["scale"])
            return out
        return res
    return {"kt": kt, "vt": vt}


def _quant_kv(x: torch.Tensor, bits: int = 8, axis: int = -2) -> Dict[str, Any]:
    """int8/int4 values + per-channel scales (amax over ``axis``, the T
    axis: -2 for [..., T, D] layouts, -1 for head-major K [..., dh, T]).
    ``torch.round`` rounds half to even, as ``jnp.round`` does.

    Torch has no int4 tensor: ``bits=4`` returns ``{"q4": packed, "n":
    last-axis length, "scale"}`` with the codes (|code| <= 7) packed two a
    byte along the last axis by ``pack_int4``; ``unpack_codes`` reverses it.
    The leading axes are unchanged, so the batch axis reads as for int8."""
    if bits not in (8, 4):
        raise ValueError(f"cross-KV quantization takes 8 or 4 bits, got {bits}")
    qmax = 127.0 if bits == 8 else 7.0
    x32 = x.float()
    amax = x32.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax / qmax, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -qmax, qmax).to(torch.int8)
    if bits == 4:
        return {"q4": pack_int4(q), "n": q.shape[-1], "scale": scale}
    return {"q": q, "scale": scale}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7] → int8 bytes holding two codes each along the
    last axis: element 2j in the low nibble, 2j+1 in the high one. An odd
    last axis is padded with one zero code."""
    if q.shape[-1] % 2:
        q = F.pad(q, (0, 1))
    return (q[..., 1::2] << 4) | (q[..., 0::2] & 0x0F)


def unpack_codes(p: Dict[str, Any]) -> torch.Tensor:
    """The int8 codes of a ``_quant_kv`` entry: as stored for int8; for
    int4 both nibbles sign-extended (the low one as ``(b << 4) >> 4``, the
    high one as ``b >> 4``, arithmetic shifts of int8) and interleaved back
    to the ``n`` codes of the last axis."""
    if "q" in p:
        return p["q"]
    b = p["q4"]
    lo, hi = (b << 4) >> 4, b >> 4
    codes = torch.stack([lo, hi], dim=-1).flatten(-2)
    return codes[..., : p["n"]]


def _cross_attention_head_major(q: torch.Tensor, ckv: Dict[str, Any],
                                n_head: int, mask: Optional[torch.Tensor],
                                cdt: torch.dtype) -> torch.Tensor:
    """Cross-attention against head-major K/V (see precompute_cross_kv).

    The whole dh**-0.5 scaling — and, when quantized, K's per-channel
    dequant scale — folds into the small q tensor; V's scale multiplies
    the output. When q carries R = B_q // B_kv sampling replicas per source
    row (replica rows consecutive per row), the replicas fold into the
    query axis, so each source row's K/V is read once per step rather than
    once per replica."""
    B, Tq, Dm = q.shape
    dh = Dm // n_head
    kv_b = (ckv["k8t"]["scale"] if "k8t" in ckv else ckv["kt"]).shape[0]
    rep = B // kv_b
    if rep > 1:
        if mask is not None:
            raise ValueError("grouped cross-attention takes no mask")
        # [B, Tq, D] -> [B_kv, H, R*Tq, dh]: (R, Tq) are adjacent row-major.
        qh = q.reshape(kv_b, rep * Tq, n_head, dh).transpose(1, 2)
    else:
        qh = q.reshape(B, Tq, n_head, dh).transpose(1, 2)
    if "k8t" in ckv:
        kscale = ckv["k8t"]["scale"].transpose(-1, -2)        # [B,H,1,dh]
        qs = (qh.float() * kscale * dh ** -0.5).to(cdt)
        kt = unpack_codes(ckv["k8t"]).to(cdt)
        vt = unpack_codes(ckv["v8t"]).to(cdt)
        vscale = ckv["v8t"]["scale"]                          # [B,H,1,dh]
    else:
        qs = qh * _in_dtype(dh ** -0.5, qh.dtype)
        kt = ckv["kt"].to(cdt)
        vt = ckv["vt"].to(cdt)
        vscale = None
    logits = matmul_f32(qs, kt)
    if mask is not None:
        logits = logits + mask
    w = torch.softmax(logits, dim=-1).to(cdt)
    if vscale is None:
        out = torch.matmul(w, vt)
    else:
        out = matmul_f32(w, vt) * vscale
    return out.to(cdt).transpose(1, 2).reshape(B, Tq, Dm)


def init_kv_cache(dims: WhisperDims, batch: int, max_len: int,
                  dtype: torch.dtype = torch.float32, bits: int = 16,
                  device="cuda", tp=None) -> List[Dict[str, torch.Tensor]]:
    """Self-attention KV cache per layer in the head-major decode layout:
    K [B,H,dh,M], V [B,H,M,dh]. ``bits=8`` stores int8 values with
    per-position f32 scales (amax over dh per cache slot); both scales fold
    exactly (K's into the logit columns, V's into the attention weights).
    ``tp`` (a shard's ``tensor_parallel``) keeps H at the local heads."""
    H, dh = dims.n_text_head, dims.n_text_state // dims.n_text_head
    if tp is not None:
        H = tp.heads(H)
    if bits not in (8, 16):
        raise ValueError(f"self-KV cache width must be 16 or 8, got {bits}")

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    if bits == 8:
        return [{"kq": z((batch, H, dh, max_len), torch.int8),
                 "ks": z((batch, H, 1, max_len), torch.float32),
                 "vq": z((batch, H, max_len, dh), torch.int8),
                 "vs": z((batch, H, max_len, 1), torch.float32)}
                for _ in range(dims.n_text_layer)]
    return [{"kt": z((batch, H, dh, max_len), dtype),
             "vt": z((batch, H, max_len, dh), dtype)}
            for _ in range(dims.n_text_layer)]


def _quant_rows(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-position int8 codes + scales (amax over ``dim``) for the int8
    self-KV cache; the clip keeps non-finite input from an undefined cast."""
    s = x.float().abs().amax(dim=dim, keepdim=True) / 127.0
    q = torch.clamp(torch.round(x.float() / torch.clamp(s, min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, s


def decoder_forward(
    model: Whisper,
    tokens: torch.Tensor,            # [B, T] token ids
    positions: torch.Tensor,         # [B, T] absolute positions
    cache_index,                     # write offset into the KV cache
    self_kv: List[Dict[str, torch.Tensor]],   # running cache (init_kv_cache)
    cross_kv: List[Dict[str, Any]],           # precompute_cross_kv
    self_mask: torch.Tensor,         # [B, 1, T, max_len] additive f32
    cross_mask: Optional[torch.Tensor],
    dims: WhisperDims,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """One decoder pass over T tokens (prefill: T=prompt len; step: T=1).

    Returns (logits [B, T, vocab] f32, self_kv). The cache is updated IN
    PLACE at ``cache_index`` (the JAX version returns an updated copy): a
    Python int writes a slice (prefill), a 0-d device tensor writes with
    ``index_copy_`` on the slot axis, so a step reads its offset from the
    device and never from the host (the captured token loop,
    ``models/decode_graph.py``). ``self_mask`` must hide future/invalid
    cache slots. A tensor-parallel shard attends with its local heads (its
    caches come from ``init_kv_cache(tp=...)`` and
    ``precompute_cross_kv``). The residual stream ``x`` is f32 (see the
    module docstring); each layer norm's output is rounded to the compute
    dtype for the products it feeds."""
    dec = model.decoder
    cdt = compute_dtype
    tp = tensor_parallel(model)
    x = dec.tok[tokens].to(cdt).float() + dec.pos[positions].to(cdt)
    n_head = dims.n_text_head
    dh = dims.n_text_state // n_head
    H = n_head if tp is None else tp.heads(n_head)
    scale = _in_dtype(dh ** -0.5, cdt)

    T_ = tokens.shape[1]
    if isinstance(cache_index, torch.Tensor):
        slots = cache_index.reshape(1) + torch.arange(T_, device=x.device)

        def write(buf, dim, val):
            buf.index_copy_(dim, slots, val.to(buf.dtype))
    else:
        sl = slice(cache_index, cache_index + T_)

        def write(buf, dim, val):
            buf[(slice(None),) * dim + (sl,)] = val.to(buf.dtype)

    for blk, skv, ckv in zip(dec.blocks, self_kv, cross_kv):
        h = layer_norm(x, blk.attn_ln).to(cdt)
        q, k_new, v_new = _column(h, [blk.attn.q, blk.attn.k, blk.attn.v],
                                  tp, n_head)
        B_, _, D_ = q.shape
        kn = k_new.view(B_, T_, H, dh).permute(0, 2, 3, 1)   # [B,H,dh,T]
        vn = v_new.view(B_, T_, H, dh).permute(0, 2, 1, 3)   # [B,H,T,dh]
        qh = q.view(B_, T_, H, dh).transpose(1, 2) * scale
        if "kq" in skv:
            kq_n, ks_n = _quant_rows(kn, dim=2)
            vq_n, vs_n = _quant_rows(vn, dim=3)
            write(skv["kq"], 3, kq_n)
            write(skv["ks"], 3, ks_n)
            write(skv["vq"], 2, vq_n)
            write(skv["vs"], 2, vs_n)
            logits = matmul_f32(qh, skv["kq"].to(cdt))
            logits = logits * skv["ks"] + self_mask
            w = torch.softmax(logits, dim=-1)
            w = (w * skv["vs"].transpose(-1, -2)).to(cdt)
            o = torch.matmul(w, skv["vq"].to(cdt))
        elif "kt" in skv:
            write(skv["kt"], 3, kn)
            write(skv["vt"], 2, vn)
            logits = matmul_f32(qh, skv["kt"].to(cdt)) + self_mask
            w = torch.softmax(logits, dim=-1).to(cdt)
            o = torch.matmul(w, skv["vt"].to(cdt))
        else:
            raise ValueError("self-KV cache must come from init_kv_cache "
                             "(head-major {'kt','vt'} or int8 layout)")
        h = o.to(cdt).transpose(1, 2).reshape(B_, T_, D_)
        x = x + _row(h, blk.attn.out, tp, n_head)

        h = layer_norm(x, blk.cross_ln).to(cdt)
        q, = _column(h, [blk.cross.q], tp, n_head)
        h = _cross_attention_head_major(q, ckv, H, cross_mask, cdt)
        x = x + _row(h, blk.cross.out, tp, n_head)
        x = x + _mlp(layer_norm(x, blk.mlp_ln).to(cdt), blk.mlp, tp)

    x = layer_norm(x, dec.ln).to(cdt)
    logits = matmul_f32(x, dec.tok.to(cdt).T)
    return logits, self_kv
