"""RE-SepFormer two-source separation in PyTorch: the JAX package's sketch,
and beside it the published model.

The role of the reference's speechbrain ``resepformer-wsj02mix`` separator
(back/api.py:705-764 load of the fine-tuned encoder/masknet/decoder
triplet; back/api.py:1077 ``separate_batch`` on each overlap span), as the
JAX package's models/resepformer.py implements it: a learned conv encoder →
50 %-overlap chunking → repeats of {intra-chunk transformer, inter-chunk
transformer over per-chunk mean tokens} → per-source ReLU masks → a
transposed-conv decoder.

``Sepformer`` is an ``nn.Module`` parameter container whose submodules are
named after the checkpoint triplet: ``encoder.conv1d`` (``nn.Conv1d``
``[N, 1, L]``), ``masknet`` (the canonical masknet naming of
``sepformer_to_state_dicts``: ``bottleneck.norm``, ``repeats.{r}.intra.{i}
.attn.qkv``, ``mask.prelu``, ...) and ``decoder.conv_tr``
(``nn.ConvTranspose1d`` ``[N, 1, L]``, unflipped). The JAX pytree keeps the
decoder kernel spatially flipped as ``[L, N, 1]`` for ``lax.conv_transpose``;
``sepformer_to_state_dicts`` and ``convert_speechbrain_sepformer`` hold the
flip. The forward is the plain function ``sepformer_separate`` over the
module, in IEEE f32 (TF32 off), as the JAX reference runs. The JAX package
has no Pallas kernel here: the attention is explicit products and a softmax
in f32, so the numerics track the reference.

``Resepformer`` (``ResepformerDims``) is the published model, speechbrain's
``resepformer-wsj02mix`` (Della Libera et al., arXiv:2206.09507; recipe
``WSJ0Mix/separation/hparams/resepformer.yaml``), as speechbrain's
``lobes/models/resepformer.py`` computes it:

- encoder: ``h = ReLU(Conv1d(1, N, L, stride L/2, no bias)(mix))``;
- ``ResourceEfficientSeparationPipeline`` with ``mem_type: av`` and no
  bottleneck: ``h`` zero-padded by ``K - T' mod K`` frames (a whole segment
  when ``K`` divides ``T'``) and cut into non-overlapping segments of ``K``;
  ``hc = 0``; for block ``i``: ``x = SegBlock_i(x + hc)``, and between two
  blocks ``hc = MemBlock_i(mean of each segment over its frames)``,
  broadcast to every frame of its segment;
- each block is ``SBTransformerBlock_wnormandskip``:
  ``out = gLN(Encoder(x + PE)) + x``, ``Encoder`` = pre-norm layers
  (``x += MHA(LN1(x))``, ``x += FFN(LN2(x))``, ReLU FFN) and a final
  LayerNorm (eps 1e-6); gLN normalises one input over channels and time
  (eps 1e-8) with a per-channel affine; PE is the interleaved sinusoid
  table (sin on even channels, cos on odd) of the sequence's length;
- ``output_fc`` = PReLU then a 1×1 conv to ``n_sources·N``, read as
  ``[T', N, n_sources]``; ReLU masks; each masked encoding through
  ``ConvTranspose1d(N, 1, L, stride L/2, no bias)``, trimmed or padded to
  the input's length.

On the card the published model's segment-block attention (softmax(q kᵀ)v
between the in- and out-projections) and every layer's LN2 → FFN → residual
run as two hand-written kernels at float32 accuracy (``ops/sb_attention.py``,
float32 FMA; ``ops/sb_ffn.py``, 3xTF32 on the tensor cores), which keep the
scores and the hidden on the SM; on the CPU as their plain versions, the
same operations as before the kernels.

The memory block attends over the segments of one input (speechbrain folds
the batch into that sequence: the same at a batch of one). Its submodules
carry speechbrain's names (``masknet.model.seg_model.0.mdl.layers.0
.self_att.att.in_proj_weight``, ...), not checked against a released
checkpoint. With ``lengths`` every row gives what it gives alone at its
own length (``sepformer_separate``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd import profiler as _profiler

from clearconverse_tpu_torch.ops import sb_attention, sb_ffn
from clearconverse_tpu_torch.utils.precision import full_f32
from clearconverse_tpu_torch.utils.tracing import StageTimer

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SepformerDims:
    enc_channels: int = 256      # encoder filters (N)
    enc_kernel: int = 16         # encoder kernel (L), stride L/2
    d_model: int = 256
    n_heads: int = 8
    ff_mult: int = 4
    chunk_size: int = 250        # K
    n_repeats: int = 2           # RE-SepFormer uses fewer repeats than SepFormer
    n_intra_layers: int = 4
    n_inter_layers: int = 4
    n_sources: int = 2

    @property
    def enc_stride(self) -> int:
        return self.enc_kernel // 2


# ------------------------------------------------------------------ module

class _Attn(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d)
        self.out = nn.Linear(d, d)


class _FF(nn.Module):
    def __init__(self, d: int, mult: int):
        super().__init__()
        self.fc1 = nn.Linear(d, mult * d)
        self.fc2 = nn.Linear(mult * d, d)


class _TfLayer(nn.Module):
    def __init__(self, d: int, mult: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(d)
        self.attn = _Attn(d)
        self.ln2 = nn.LayerNorm(d)
        self.ff = _FF(d, mult)


class _Repeat(nn.Module):
    def __init__(self, dims: SepformerDims):
        super().__init__()
        d, m = dims.d_model, dims.ff_mult
        self.intra = nn.ModuleList(_TfLayer(d, m)
                                   for _ in range(dims.n_intra_layers))
        self.intra_norm = nn.LayerNorm(d)
        self.inter = nn.ModuleList(_TfLayer(d, m)
                                   for _ in range(dims.n_inter_layers))
        self.inter_norm = nn.LayerNorm(d)


class _Bottleneck(nn.Module):
    def __init__(self, n: int, d: int):
        super().__init__()
        self.norm = nn.LayerNorm(n)
        self.proj = nn.Linear(n, d)


class _Mask(nn.Module):
    def __init__(self, d: int, n_out: int):
        super().__init__()
        self.prelu = nn.PReLU(1)
        self.proj = nn.Linear(d, n_out)


class _Masknet(nn.Module):
    def __init__(self, dims: SepformerDims):
        super().__init__()
        self.bottleneck = _Bottleneck(dims.enc_channels, dims.d_model)
        self.repeats = nn.ModuleList(_Repeat(dims)
                                     for _ in range(dims.n_repeats))
        self.mask = _Mask(dims.d_model, dims.n_sources * dims.enc_channels)


class _Encoder(nn.Module):
    def __init__(self, dims: SepformerDims):
        super().__init__()
        self.conv1d = nn.Conv1d(1, dims.enc_channels, dims.enc_kernel,
                                stride=dims.enc_stride, bias=False)


class _Decoder(nn.Module):
    def __init__(self, dims: SepformerDims):
        super().__init__()
        self.conv_tr = nn.ConvTranspose1d(dims.enc_channels, 1,
                                          dims.enc_kernel,
                                          stride=dims.enc_stride, bias=False)


class Sepformer(nn.Module):
    """Parameter container; see the module docstring for the layout.
    ``dims`` carries the head count and chunk size, which the weights do
    not determine."""

    def __init__(self, dims: SepformerDims):
        super().__init__()
        self.dims = dims
        self.encoder = _Encoder(dims)
        self.masknet = _Masknet(dims)
        self.decoder = _Decoder(dims)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        return sepformer_separate(self, mix)


# ------------------------------------------------------------------ weights

def init_sepformer_params(seed: int, dims: SepformerDims = SepformerDims()
                          ) -> Dict[str, Any]:
    """Seeded random init in the JAX package's layout and distributions
    (normal weights scaled by fan-in^-0.5, zero biases, unit norms, PReLU
    slope 0.25), as numpy. The draws come from a CPU ``torch.Generator``,
    so one seed gives the same weights on every device (not the JAX
    package's numbers)."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).numpy()

    def lin(n_in, n_out):
        return {"w": normal((n_in, n_out), n_in ** -0.5),
                "b": np.zeros((n_out,), np.float32)}

    def ln(d):
        return {"g": np.ones((d,), np.float32), "b": np.zeros((d,), np.float32)}

    def tf_layer():
        return {"ln1": ln(d),
                "attn": {"qkv": lin(d, 3 * d), "out": lin(d, d)},
                "ln2": ln(d),
                "ff": {"fc1": lin(d, dims.ff_mult * d),
                       "fc2": lin(dims.ff_mult * d, d)}}

    d, N, L = dims.d_model, dims.enc_channels, dims.enc_kernel
    p: Dict[str, Any] = {
        "encoder": {"w": normal((L, 1, N), L ** -0.5)},
        "bottleneck": {"ln": ln(N), "proj": lin(N, d)},
        "repeats": [],
        "mask_out": {"prelu_a": np.asarray(0.25, np.float32),
                     "proj": lin(d, dims.n_sources * N)},
        "decoder": {"w": normal((L, N, 1), N ** -0.5)},
    }
    for _ in range(dims.n_repeats):
        p["repeats"].append({
            "intra": [tf_layer() for _ in range(dims.n_intra_layers)],
            "intra_ln": ln(d),
            "inter": [tf_layer() for _ in range(dims.n_inter_layers)],
            "inter_ln": ln(d),
        })
    return p


@torch.no_grad()
def sepformer_from_jax_params(tree: Dict[str, Any], dims: SepformerDims,
                              device="cuda") -> Sepformer:
    """The JAX package's RE-SepFormer pytree (numpy leaves) → the port's
    ``Sepformer`` on ``device``, through the checkpoint triplet
    (``sepformer_to_state_dicts``), whose names the module shares. With
    ``ResepformerDims`` the tree is the published layout's triplet
    (``convert_speechbrain_sepformer``) and a ``Resepformer`` comes back."""
    enc_sd, mask_sd, dec_sd = sepformer_to_state_dicts(tree)
    with torch.device("meta"):
        model = (Resepformer(dims) if isinstance(dims, ResepformerDims)
                 else Sepformer(dims))
    model = model.to_empty(device="cpu")
    for sub, sd in ((model.encoder, enc_sd), (model.masknet, mask_sd),
                    (model.decoder, dec_sd)):
        sub.load_state_dict({k: torch.from_numpy(
            np.array(np.asarray(v), np.float32)) for k, v in sd.items()})
    return model.to(device).requires_grad_(False).eval()


def init_sepformer(dims: SepformerDims = SepformerDims(), seed: int = 0,
                   device="cuda") -> Sepformer:
    """``init_sepformer_params`` placed on ``device``."""
    return sepformer_from_jax_params(init_sepformer_params(seed, dims), dims,
                                     device)


# ------------------------------------------------------------------ ops

def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, eps: float = 1e-5
                ) -> torch.Tensor:
    """Population variance, eps 1e-5 (``jnp.var``)."""
    return F.layer_norm(x, (x.shape[-1],), ln.weight, ln.bias, eps)


def _mha(x: torch.Tensor, attn: _Attn, n_heads: int) -> torch.Tensor:
    B, T, D = x.shape
    dh = D // n_heads
    q, k, v = F.linear(x, attn.qkv.weight, attn.qkv.bias).chunk(3, dim=-1)
    q = q.reshape(B, T, n_heads, dh).transpose(1, 2) * dh ** -0.5
    k = k.reshape(B, T, n_heads, dh).transpose(1, 2)
    v = v.reshape(B, T, n_heads, dh).transpose(1, 2)
    w = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
    o = torch.matmul(w, v).transpose(1, 2).reshape(B, T, D)
    return F.linear(o, attn.out.weight, attn.out.bias)


def _tf_forward(x: torch.Tensor, layers: nn.ModuleList, n_heads: int
                ) -> torch.Tensor:
    for lyr in layers:
        x = x + _mha(_layer_norm(x, lyr.ln1), lyr.attn, n_heads)
        h = _layer_norm(x, lyr.ln2)
        x = x + F.linear(F.relu(F.linear(h, lyr.ff.fc1.weight, lyr.ff.fc1.bias)),
                         lyr.ff.fc2.weight, lyr.ff.fc2.bias)
    return x


def _positional(T: int, d: int, dtype, device) -> torch.Tensor:
    """Sinusoidal table built in float64 numpy, then cast (as JAX does)."""
    pos = np.arange(T)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    pe = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    return torch.as_tensor(pe, dtype=dtype, device=device)


def _chunk(x: torch.Tensor, K: int) -> Tuple[torch.Tensor, int]:
    """[B, T, D] → [B, S, K, D] with 50 % overlap (hop K//2), zero-padded."""
    B, T, D = x.shape
    hop = K // 2
    n_chunks = max(1, -(-(max(T - K, 0)) // hop) + 1)
    total = (n_chunks - 1) * hop + K
    x = F.pad(x, (0, 0, 0, total - T))
    return x.unfold(1, K, hop).permute(0, 1, 3, 2), T


def _unchunk(x: torch.Tensor, T: int) -> torch.Tensor:
    """[B, S, K, D] 50 %-overlap chunks → [B, T, D] by coverage-weighted
    overlap-add: interior positions (two chunks) are halved, edges (one)
    kept, so the gain is uniform. This differs from speechbrain's
    ``_over_add`` on purpose, as the JAX package's ``_unchunk`` does (see
    its docstring). With hop = K/2 no position has more than two chunks,
    so the sums do not depend on the order of the additions."""
    B, S, K, D = x.shape
    hop = K // 2
    total = (S - 1) * hop + K
    idx = ((torch.arange(S, device=x.device) * hop)[:, None]
           + torch.arange(K, device=x.device)[None, :]).reshape(-1)
    out = torch.zeros((B, total, D), dtype=x.dtype, device=x.device)
    out.index_add_(1, idx, x.reshape(B, S * K, D))
    weight = torch.zeros((total,), dtype=x.dtype, device=x.device)
    weight.index_add_(0, idx, torch.ones_like(idx, dtype=x.dtype))
    return (out / weight.clamp(min=1.0)[None, :, None])[:, :T]


# ------------------------------------------------------------------ model

@torch.no_grad()
def sepformer_separate(model: Union[Sepformer, "Resepformer"],
                       mix: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None,
                       timer: Optional[StageTimer] = None) -> torch.Tensor:
    """[B, T] mixture → [B, T, n_sources] separated waveforms (the
    speechbrain ``separate_batch`` contract, back/api.py:1077).

    The published layout (``Resepformer``) reads ``lengths`` ([B] valid
    samples of each row; None = all ``T``): each row then gives what it
    gives alone at its own length, and a row of length 0 gives zeros. It
    opens the spans ``sep.{encoder,seg_block,mem_block,decoder}`` on
    ``timer`` (and, without one, profiler ranges while the profiler runs).
    The sketch separates the padded rows whole, as the JAX package does,
    and reads neither."""
    if isinstance(model, Resepformer):
        return _resepformer_separate(model, mix, lengths, timer)
    dims = model.dims
    if mix.ndim == 1:
        mix = mix[None]
    mix = mix.to(torch.float32)
    B, T = mix.shape
    mn = model.masknet
    with full_f32():
        # Encoder: a VALID strided conv, then ReLU → [B, T', N].
        h = F.relu(F.conv1d(mix[:, None, :], model.encoder.conv1d.weight,
                            stride=dims.enc_stride)).transpose(1, 2)
        Tp = h.shape[1]
        x = _layer_norm(h, mn.bottleneck.norm)
        x = F.linear(x, mn.bottleneck.proj.weight, mn.bottleneck.proj.bias)

        chunks, _ = _chunk(x, dims.chunk_size)                 # [B,S,K,d]
        _, S, K, d = chunks.shape
        pe_k = _positional(K, d, chunks.dtype, chunks.device)
        pe_s = _positional(S, d, chunks.dtype, chunks.device)
        for rep in mn.repeats:
            # Intra-chunk: [B*S, K, d].
            flat = chunks.reshape(B * S, K, d) + pe_k[None]
            flat = _tf_forward(flat, rep.intra, dims.n_heads)
            chunks = chunks + _layer_norm(flat.reshape(B, S, K, d),
                                          rep.intra_norm)
            # Inter-chunk over per-chunk summary tokens.
            summary = chunks.mean(dim=2) + pe_s[None]          # [B,S,d]
            summary = _tf_forward(summary, rep.inter, dims.n_heads)
            chunks = chunks + _layer_norm(summary, rep.inter_norm)[:, :, None, :]

        x = _unchunk(chunks, Tp)                               # [B,T',d]
        a = mn.mask.prelu.weight.reshape(())
        x = torch.where(x >= 0, x, a * x)                      # PReLU
        masks = F.relu(F.linear(x, mn.mask.proj.weight, mn.mask.proj.bias))
        masks = masks.reshape(B, Tp, dims.n_sources, dims.enc_channels)

        # Decoder: every source's masked encoding through one transposed
        # conv, [B*src, N, T'] → [B*src, T'·stride + stride].
        masked = (h[:, :, None, :] * masks).permute(0, 2, 3, 1)
        y = F.conv_transpose1d(
            masked.reshape(B * dims.n_sources, dims.enc_channels, Tp),
            model.decoder.conv_tr.weight, stride=dims.enc_stride)[:, 0, :]
    out = y.reshape(B, dims.n_sources, -1)[:, :, :T].transpose(1, 2)
    if out.shape[1] < T:
        out = F.pad(out, (0, 0, 0, T - out.shape[1]))
    return out.contiguous()


# ------------------------------------------------- the published layout

@dataclasses.dataclass(frozen=True)
class ResepformerDims:
    """speechbrain's ``resepformer-wsj02mix`` widths (resepformer.yaml).
    There is no bottleneck: the transformers run at the encoder's ``N``."""
    enc_channels: int = 128      # N_encoder_out = out_channels = d_model
    enc_kernel: int = 16         # kernel_size; stride kernel_size / 2
    n_heads: int = 8
    d_ffn: int = 1024
    segment_size: int = 150      # K, non-overlapping
    n_blocks: int = 2            # segment blocks (layer), a memory block between two
    n_layers: int = 8            # transformer layers of every block
    n_sources: int = 2

    @property
    def enc_stride(self) -> int:
        return self.enc_kernel // 2

    @property
    def d_model(self) -> int:
        return self.enc_channels


# TorchConfig.separator names → the layout and widths the bundle builds.
SEPARATORS = {"sketch": SepformerDims(),
              "resepformer-wsj02mix": ResepformerDims()}


class _SbNorm(nn.Module):
    """speechbrain's ``nnet.normalization.LayerNorm`` (eps 1e-6)."""

    def __init__(self, d: int):
        super().__init__()
        self.norm = nn.LayerNorm(d, eps=1e-6)


class _SbAttention(nn.Module):
    """speechbrain's ``MultiheadAttention``: a packed in-projection."""

    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.att = nn.MultiheadAttention(d, n_heads, bias=True)


class _SbFFN(nn.Module):
    """speechbrain's ``PositionalwiseFeedForward`` (Linear, ReLU, dropout,
    Linear)."""

    def __init__(self, d: int, d_ffn: int):
        super().__init__()
        self.ffn = nn.Sequential(nn.Linear(d, d_ffn), nn.ReLU(),
                                 nn.Dropout(0.0), nn.Linear(d_ffn, d))


class _SbLayer(nn.Module):
    def __init__(self, dims: ResepformerDims):
        super().__init__()
        d = dims.d_model
        self.self_att = _SbAttention(d, dims.n_heads)
        self.pos_ffn = _SbFFN(d, dims.d_ffn)
        self.norm1 = _SbNorm(d)
        self.norm2 = _SbNorm(d)


class _SbEncoder(nn.Module):
    def __init__(self, dims: ResepformerDims):
        super().__init__()
        self.layers = nn.ModuleList(_SbLayer(dims)
                                    for _ in range(dims.n_layers))
        self.norm = _SbNorm(dims.d_model)


class _GlobalLayerNorm(nn.Module):
    """gLN over channels and time, affine ``[N, 1]``."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, 1))
        self.bias = nn.Parameter(torch.zeros(d, 1))


class _SbBlock(nn.Module):
    """``SBTransformerBlock_wnormandskip``."""

    def __init__(self, dims: ResepformerDims):
        super().__init__()
        self.mdl = _SbEncoder(dims)
        self.norm = _GlobalLayerNorm(dims.d_model)


class _Pipeline(nn.Module):
    """``ResourceEfficientSeparationPipeline`` (``mem_type: av``)."""

    def __init__(self, dims: ResepformerDims):
        super().__init__()
        self.seg_model = nn.ModuleList(_SbBlock(dims)
                                       for _ in range(dims.n_blocks))
        self.mem_model = nn.ModuleList(_SbBlock(dims)
                                       for _ in range(dims.n_blocks - 1))
        self.output_fc = nn.Sequential(
            nn.PReLU(), nn.Conv1d(dims.enc_channels,
                                  dims.n_sources * dims.enc_channels, 1))


class _ResepMasknet(nn.Module):
    """``ResourceEfficientSeparator``."""

    def __init__(self, dims: ResepformerDims):
        super().__init__()
        self.model = _Pipeline(dims)


class Resepformer(nn.Module):
    """The published RE-SepFormer; parameter container, forward in
    ``sepformer_separate``."""

    def __init__(self, dims: ResepformerDims):
        super().__init__()
        self.dims = dims
        self.encoder = _Encoder(dims)
        self.masknet = _ResepMasknet(dims)
        self.decoder = _Decoder(dims)

    def forward(self, mix: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return sepformer_separate(self, mix, lengths)


@torch.no_grad()
def init_resepformer(dims: ResepformerDims = ResepformerDims(), seed: int = 0,
                     device="cuda") -> Resepformer:
    """Seeded init from a CPU ``torch.Generator`` (one seed, the same
    weights on every device): matrices and kernels normal with std
    fan_in^-0.5, biases 0, norms 1 and 0, the PReLU slope 0.25."""
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        model = Resepformer(dims)
    model = model.to_empty(device="cpu")
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.ndim >= 2 and "norm" not in name:
            # ConvTranspose1d keeps [in, out, k]: its fan-in is N, as the
            # sketch draws it.
            fan_in = p.shape[0] if name.startswith("decoder") else p[0].numel()
            p.copy_(torch.randn(p.shape, generator=gen) * fan_in ** -0.5)
        elif name.endswith("output_fc.0.weight"):
            p.fill_(0.25)
        elif leaf == "weight":
            p.fill_(1.0)
        else:
            p.zero_()
    return model.to(device).requires_grad_(False).eval()


@functools.lru_cache(maxsize=64)
def _sb_positional_cpu(T: int, d: int) -> torch.Tensor:
    """speechbrain's ``PositionalEncoding`` table, built in f32 on the CPU
    as speechbrain builds it: sin on even channels, cos on odd."""
    pos = torch.arange(T, dtype=torch.float32)[:, None]
    den = torch.exp(torch.arange(0, d, 2, dtype=torch.float32)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros(T, d)
    pe[:, 0::2] = torch.sin(pos * den)
    pe[:, 1::2] = torch.cos(pos * den)
    return pe


def _sb_layer_norm(x: torch.Tensor, n: _SbNorm) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), n.norm.weight, n.norm.bias, 1e-6)


def _sb_mha(x: torch.Tensor, att: nn.MultiheadAttention,
            key_ok: Optional[torch.Tensor]) -> torch.Tensor:
    """Self-attention over [B, T, d]; ``key_ok`` [B, T] masks keys. The
    segment blocks' unmasked attention goes through the segment attention
    kernel (``ops/sb_attention.py``) where it takes the shape; the memory
    block's masked one stays on its plain version."""
    qkv = F.linear(x, att.in_proj_weight, att.in_proj_bias)
    H = att.num_heads
    if sb_attention.fused(qkv.shape, H, key_ok):
        o = sb_attention.seg_attention(qkv, H)
    else:
        o = sb_attention.seg_attention_plain(qkv, H, key_ok)
    return F.linear(o, att.out_proj.weight, att.out_proj.bias)


def _global_norm(x: torch.Tensor, n: _GlobalLayerNorm,
                 ok: Optional[torch.Tensor]) -> torch.Tensor:
    """gLN of each input [T, d] of x [B, T, d] over its valid positions
    (``ok`` [B, T]; None = all), eps 1e-8."""
    if ok is None:
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(1, 2), keepdim=True)
    else:
        w = ok[:, :, None].to(x.dtype)
        count = w.sum(dim=(1, 2), keepdim=True) * x.shape[-1]
        mean = (x * w).sum(dim=(1, 2), keepdim=True) / count
        var = (((x - mean) * w) ** 2).sum(dim=(1, 2), keepdim=True) / count
    return (x - mean) / torch.sqrt(var + 1e-8) * n.weight[:, 0] + n.bias[:, 0]


def _sb_block(x: torch.Tensor, blk: _SbBlock,
              ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``SBTransformerBlock_wnormandskip`` over [B, T, d]; ``ok`` [B, T]
    marks each input's own positions (attention keys, gLN statistics)."""
    pe = _sb_positional_cpu(x.shape[1], x.shape[2]).to(x.device, x.dtype)
    h = x + pe
    for lyr in blk.mdl.layers:
        h = h + _sb_mha(_sb_layer_norm(h, lyr.norm1), lyr.self_att.att, ok)
        fc1, fc2 = lyr.pos_ffn.ffn[0], lyr.pos_ffn.ffn[3]
        # LN2, fc1, ReLU, fc2 and the residual: one kernel where it takes
        # the widths (ops/sb_ffn.py), the plain version otherwise.
        ffn = (sb_ffn.sb_ffn if sb_ffn.fused(h.shape[-1], fc1.out_features)
               else sb_ffn.sb_ffn_plain)
        h = ffn(h, lyr.norm2.norm.weight, lyr.norm2.norm.bias, fc1.weight,
                fc1.bias, fc2.weight, fc2.bias, 1e-6)
    h = _sb_layer_norm(h, blk.mdl.norm)
    return _global_norm(h, blk.norm, ok) + x


def prepare_kernels(model: nn.Module) -> None:
    """Splits the feed-forward weights of a published separator on the card
    for ``ops/sb_ffn.py``'s kernel once, ahead of its first call (the
    kernel's wrapper splits them again when they change); nothing for the
    sketch or on the CPU."""
    if not isinstance(model, Resepformer):
        return
    pipe = model.masknet.model
    for blk in (*pipe.seg_model, *pipe.mem_model):
        for lyr in blk.mdl.layers:
            sb_ffn.prepare(lyr.pos_ffn.ffn[0].weight, lyr.pos_ffn.ffn[3].weight)


def _span(timer: Optional[StageTimer], name: str):
    """``timer``'s span ``sep.<name>``; without one, a profiler range while
    the profiler runs, else nothing (one flag read)."""
    if timer is not None:
        return timer.stage("sep." + name)
    if _profiler._is_profiler_enabled:
        return StageTimer().stage("sep." + name)
    return contextlib.nullcontext()


def resepformer_frames(lengths: torch.Tensor, dims: ResepformerDims
                       ) -> torch.Tensor:
    """Encoder frames of rows of ``lengths`` samples: (len − L)//(L/2) + 1,
    0 below one kernel."""
    L, st = dims.enc_kernel, dims.enc_stride
    return torch.where(lengths >= L, (lengths - L) // st + 1,
                       torch.zeros_like(lengths))


def _resepformer_separate(model: Resepformer, mix: torch.Tensor,
                          lengths: Optional[torch.Tensor],
                          timer: Optional[StageTimer]) -> torch.Tensor:
    dims = model.dims
    if mix.ndim == 1:
        mix = mix[None]
    mix = mix.to(torch.float32)
    B, T = mix.shape
    N, K, L, st = (dims.enc_channels, dims.segment_size, dims.enc_kernel,
                   dims.enc_stride)
    pipe = model.masknet.model
    dev = mix.device
    if T < L:
        return torch.zeros((B, T, dims.n_sources), device=dev)
    with full_f32():
        with _span(timer, "encoder"):
            h = F.relu(F.conv1d(mix[:, None, :], model.encoder.conv1d.weight,
                                stride=st))                     # [B, N, T']
            Tp = h.shape[-1]
            if lengths is None:
                frames = torch.full((B,), Tp, device=dev, dtype=torch.long)
            else:
                frames = resepformer_frames(
                    torch.as_tensor(lengths, device=dev).long(), dims)
            # Frames that straddle or pass a row's end are zero, as they
            # are absent when the row runs alone.
            h = h * (torch.arange(Tp, device=dev)[None, :]
                     < frames[:, None])[:, None, :]
            # speechbrain pads K - T' mod K frames: a whole segment when K
            # divides T'. Each row has its own count of segments.
            S = Tp // K + 1
            seg_n = frames // K + 1                              # [B]
            seg_ok = torch.arange(S, device=dev)[None, :] < seg_n[:, None]
            x = F.pad(h.transpose(1, 2), (0, 0, 0, S * K - Tp))
            x = x.reshape(B * S, K, N)
            # A row's segments past its own count are never run.
            run = seg_ok.reshape(-1).nonzero().squeeze(1)
            xs = x[run]
            hc = None
        for i, seg_blk in enumerate(pipe.seg_model):
            with _span(timer, "seg_block"):
                xs = _sb_block(xs if hc is None else xs + hc, seg_blk)
            if i < len(pipe.mem_model):
                with _span(timer, "mem_block"):
                    summary = torch.zeros((B * S, N), device=dev)
                    summary[run] = xs.mean(dim=1)
                    mem = _sb_block(summary.reshape(B, S, N),
                                    pipe.mem_model[i], seg_ok)
                    hc = mem.reshape(B * S, 1, N)[run]
        with _span(timer, "decoder"):
            x = torch.zeros((B * S, K, N), device=dev)
            x[run] = xs
            x = x.reshape(B, S * K, N)[:, :Tp].transpose(1, 2)   # [B, N, T']
            prelu, proj = pipe.output_fc
            a = prelu.weight.reshape(())
            x = torch.where(x >= 0, x, a * x)
            masks = F.relu(F.conv1d(x, proj.weight, proj.bias))  # [B, N·src, T']
            masks = masks.reshape(B, N, dims.n_sources, Tp)
            masked = h[:, :, None, :] * masks                    # [B, N, src, T']
            y = F.conv_transpose1d(
                masked.permute(0, 2, 1, 3).reshape(B * dims.n_sources, N, Tp),
                model.decoder.conv_tr.weight, stride=st)[:, 0, :]
    out = y.reshape(B, dims.n_sources, -1)[:, :, :T].transpose(1, 2)
    if out.shape[1] < T:
        out = F.pad(out, (0, 0, 0, T - out.shape[1]))
    return out.contiguous()


def resepformer_segments(lengths, dims: ResepformerDims) -> int:
    """Segments the separator runs for rows of ``lengths`` samples."""
    frames = resepformer_frames(torch.as_tensor(lengths).long(), dims)
    return int((frames // dims.segment_size + 1).sum())


# ------------------------------------------------------------ checkpoints

def convert_speechbrain_sepformer(encoder_sd: Dict[str, Any],
                                  masknet_sd: Dict[str, Any],
                                  decoder_sd: Dict[str, Any],
                                  dims: SepformerDims = SepformerDims()
                                  ) -> Dict[str, Any]:
    """speechbrain ckpt triplet (the reference's resepformer-ft layout,
    back/api.py:727-746) → the JAX package's pytree layout, numpy leaves.
    Encoder and decoder convert exactly; the masknet imports this
    framework's canonical naming (``sepformer_to_state_dicts``), and any
    other naming keeps the seeded init with a warning, as the JAX package
    does."""
    def np_(v):
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)

    if any(k.startswith("model.seg_model.") for k in masknet_sd):
        # The published layout keeps its module's names as they are.
        return {"layout": "resepformer",
                **{part: {k: np_(v) for k, v in sd.items()} for part, sd in
                   (("encoder", encoder_sd), ("masknet", masknet_sd),
                    ("decoder", decoder_sd))}}
    params = init_sepformer_params(0, dims)
    if "conv1d.weight" in encoder_sd:
        params["encoder"]["w"] = np_(encoder_sd["conv1d.weight"]).transpose(2, 1, 0)
    if "conv_tr.weight" in decoder_sd:  # torch ConvTranspose1d [in, out, k]
        # lax.conv_transpose is an lhs-dilated plain conv: it equals torch's
        # transposed conv only with the kernel flipped along the spatial axis.
        params["decoder"]["w"] = np.ascontiguousarray(
            np_(decoder_sd["conv_tr.weight"]).transpose(2, 0, 1)[::-1])
    if "bottleneck.proj.weight" in masknet_sd:
        params = _import_masknet(params, masknet_sd, np_)
    else:
        logger.warning(
            "resepformer masknet state dict uses unrecognized naming "
            "(first keys: %s); masknet stays at random init — only "
            "encoder/decoder were imported. Export checkpoints via "
            "sepformer_to_state_dicts for a full import.",
            sorted(masknet_sd)[:3])
    return params


def _lin_in(sd, pre, np_):
    p = {"w": np_(sd[f"{pre}.weight"]).T}
    if f"{pre}.bias" in sd:
        p["b"] = np_(sd[f"{pre}.bias"])
    return p


def _ln_in(sd, pre, np_):
    return {"g": np_(sd[f"{pre}.weight"]), "b": np_(sd[f"{pre}.bias"])}


def _import_masknet(params, sd, np_):
    params["bottleneck"] = {"ln": _ln_in(sd, "bottleneck.norm", np_),
                            "proj": _lin_in(sd, "bottleneck.proj", np_)}

    def tf_layer(pre):
        return {
            "ln1": _ln_in(sd, f"{pre}.ln1", np_),
            "attn": {"qkv": _lin_in(sd, f"{pre}.attn.qkv", np_),
                     "out": _lin_in(sd, f"{pre}.attn.out", np_)},
            "ln2": _ln_in(sd, f"{pre}.ln2", np_),
            "ff": {"fc1": _lin_in(sd, f"{pre}.ff.fc1", np_),
                   "fc2": _lin_in(sd, f"{pre}.ff.fc2", np_)},
        }

    repeats = []
    r = 0
    while f"repeats.{r}.intra_norm.weight" in sd:
        intra, inter = [], []
        i = 0
        while f"repeats.{r}.intra.{i}.ln1.weight" in sd:
            intra.append(tf_layer(f"repeats.{r}.intra.{i}"))
            i += 1
        i = 0
        while f"repeats.{r}.inter.{i}.ln1.weight" in sd:
            inter.append(tf_layer(f"repeats.{r}.inter.{i}"))
            i += 1
        repeats.append({
            "intra": intra,
            "intra_ln": _ln_in(sd, f"repeats.{r}.intra_norm", np_),
            "inter": inter,
            "inter_ln": _ln_in(sd, f"repeats.{r}.inter_norm", np_),
        })
        r += 1
    params["repeats"] = repeats
    params["mask_out"] = {"prelu_a": np_(sd["mask.prelu.weight"]).reshape(()),
                          "proj": _lin_in(sd, "mask.proj", np_)}
    return params


def infer_sepformer_dims(params: Dict[str, Any],
                         fallback: SepformerDims = SepformerDims()
                         ) -> SepformerDims:
    """Dims recoverable from a converted pytree's shapes; the head count and
    chunk size (absent from weight shapes) come from ``fallback`` (for the
    published layout, from ``ResepformerDims()`` unless ``fallback`` is
    one)."""
    if params.get("layout") == "resepformer":
        return _infer_resepformer_dims(params, fallback)
    enc_w = params["encoder"]["w"]
    enc_channels = int(np.shape(enc_w)[2])
    d_model = int(np.shape(params["bottleneck"]["proj"]["w"])[1])
    rep = params["repeats"][0]
    return dataclasses.replace(
        fallback,
        enc_channels=enc_channels,
        enc_kernel=int(np.shape(enc_w)[0]),
        d_model=d_model,
        ff_mult=int(np.shape(rep["intra"][0]["ff"]["fc1"]["w"])[1]) // d_model,
        n_repeats=len(params["repeats"]),
        n_intra_layers=len(rep["intra"]),
        n_inter_layers=len(rep["inter"]),
        n_sources=int(np.shape(params["mask_out"]["proj"]["w"])[1])
        // enc_channels,
    )


def _infer_resepformer_dims(tree: Dict[str, Any], fallback
                            ) -> ResepformerDims:
    m = tree["masknet"]
    N, _, L = np.shape(tree["encoder"]["conv1d.weight"])

    def count(fmt):
        n = 0
        while fmt.format(n) in m:
            n += 1
        return n

    base = fallback if isinstance(fallback, ResepformerDims) \
        else ResepformerDims()
    return dataclasses.replace(
        base, enc_channels=int(N), enc_kernel=int(L),
        d_ffn=int(np.shape(
            m["model.seg_model.0.mdl.layers.0.pos_ffn.ffn.0.weight"])[0]),
        n_blocks=count("model.seg_model.{}.norm.weight"),
        n_layers=count("model.seg_model.0.mdl.layers.{}.norm1.norm.weight"),
        n_sources=int(np.shape(m["model.output_fc.1.weight"])[0]) // int(N))


def dims_to_meta(dims) -> Dict[str, Any]:
    """Dims as a ``save_native`` meta block; the published layout is
    marked ``"layout": "resepformer"``."""
    out = dataclasses.asdict(dims)
    if isinstance(dims, ResepformerDims):
        out["layout"] = "resepformer"
    return out


def dims_from_meta(meta: Dict[str, Any]):
    """``dims_to_meta``'s inverse; keys a dims class lacks are dropped."""
    cls = ResepformerDims if meta.get("layout") == "resepformer" \
        else SepformerDims
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in meta.items() if k in names})


def sepformer_to_state_dicts(params: Dict[str, Any]):
    """The pytree as the ckpt triplet (encoder, masknet, decoder) of numpy
    arrays in this framework's canonical naming — the reference's
    resepformer-ft layout, round-trippable through
    ``convert_speechbrain_sepformer``. The published layout's tree is the
    triplet already."""
    def t(x):
        return np.asarray(x)

    if params.get("layout") == "resepformer":
        return tuple({k: t(v) for k, v in params[part].items()}
                     for part in ("encoder", "masknet", "decoder"))
    encoder_sd = {"conv1d.weight": t(params["encoder"]["w"]).transpose(2, 1, 0)}
    # pytree [k, in, out] (spatially flipped) → torch ConvTranspose1d [in, out, k]
    decoder_sd = {"conv_tr.weight": np.ascontiguousarray(
        t(params["decoder"]["w"])[::-1].transpose(1, 2, 0))}

    sd: Dict[str, np.ndarray] = {}

    def put_lin(pre, p):
        sd[f"{pre}.weight"] = t(p["w"]).T
        if "b" in p:
            sd[f"{pre}.bias"] = t(p["b"])

    def put_ln(pre, p):
        sd[f"{pre}.weight"] = t(p["g"])
        sd[f"{pre}.bias"] = t(p["b"])

    put_ln("bottleneck.norm", params["bottleneck"]["ln"])
    put_lin("bottleneck.proj", params["bottleneck"]["proj"])
    for r, rep in enumerate(params["repeats"]):
        for kind in ("intra", "inter"):
            for i, lyr in enumerate(rep[kind]):
                pre = f"repeats.{r}.{kind}.{i}"
                put_ln(f"{pre}.ln1", lyr["ln1"])
                put_lin(f"{pre}.attn.qkv", lyr["attn"]["qkv"])
                put_lin(f"{pre}.attn.out", lyr["attn"]["out"])
                put_ln(f"{pre}.ln2", lyr["ln2"])
                put_lin(f"{pre}.ff.fc1", lyr["ff"]["fc1"])
                put_lin(f"{pre}.ff.fc2", lyr["ff"]["fc2"])
            put_ln(f"repeats.{r}.{kind}_norm", rep[f"{kind}_ln"])
    sd["mask.prelu.weight"] = t(params["mask_out"]["prelu_a"]).reshape(1)
    put_lin("mask.proj", params["mask_out"]["proj"])
    return encoder_sd, sd, decoder_sd
