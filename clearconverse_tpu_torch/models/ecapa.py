"""ECAPA-TDNN speaker embedder in PyTorch.

The role of the reference's embedding model (back/api.py:770-774, used for
speaker profiles back/api.py:893-959 and window matching
back/api.py:961-1050): waveform → a fixed-size, cosine-comparable speaker
embedding. The speechbrain ``spkrec-ecapa-voxceleb`` layout: fbank frontend
→ Conv1d(k=5) → 3 SE-Res2Net blocks (dilations 2, 3, 4) → multi-layer
feature aggregation → attentive statistics pooling → linear to 192.

Weights are a tree of tensors with the JAX package's structure
(``ecapa_from_jax_params``; conv weights turn to torch's [out, in, k]).
Batch rows carry frame-validity masks so padded segments pool correctly.
Everything runs in IEEE f32 (TF32 off), as the JAX reference does.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from clearconverse_tpu_torch.utils.precision import full_f32


@dataclasses.dataclass(frozen=True)
class EcapaDims:
    n_mels: int = 80
    channels: int = 512
    mfa_channels: int = 1536     # multi-layer aggregation width
    attention_channels: int = 128
    embedding_dim: int = 192
    res2net_scale: int = 8
    dilations: tuple = (2, 3, 4)


def _sb_dft_matrices(n_fft: int = 400):
    """Hamming-windowed real-DFT matrices [n_fft, n_freq] with speechbrain
    STFT semantics (torch.hamming_window is periodic: 0.54 - 0.46
    cos(2πn/N))."""
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    ang = 2.0 * np.pi * n[:, None] * k[None, :] / n_fft
    window = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / n_fft)
    cos_m = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_m = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_m, sin_m


def _sb_mel_filterbank(n_mels: int = 80, n_fft: int = 400,
                       sr: int = 16000, f_min: float = 0.0,
                       f_max: float = 8000.0) -> np.ndarray:
    """[n_freq, n_mels] speechbrain Filterbank: HTK mel spacing and
    symmetric triangles whose half-width is each centre's left gap, with no
    area normalization (neither the slaney/librosa bank of audio/mel.py nor
    Kaldi's asymmetric one)."""
    mel = np.linspace(2595.0 * np.log10(1 + f_min / 700),
                      2595.0 * np.log10(1 + f_max / 700), n_mels + 2)
    hz = 700.0 * (10.0 ** (mel / 2595.0) - 1)
    f_central = hz[1:-1]                         # [n_mels]
    band = (hz[1:] - hz[:-1])[:-1]               # left gap of each centre
    all_freqs = np.linspace(0, sr // 2, n_fft // 2 + 1)
    slope = (all_freqs[None, :] - f_central[:, None]) / band[:, None]
    tri = np.maximum(0.0, np.minimum(slope + 1.0, -slope + 1.0))
    return tri.T.astype(np.float32)              # [n_freq, n_mels]


@lru_cache(maxsize=8)
def _fbank_matrices(n_mels: int, device: torch.device):
    cos_m, sin_m = _sb_dft_matrices(400)
    return (torch.from_numpy(cos_m).to(device),
            torch.from_numpy(sin_m).to(device),
            torch.from_numpy(_sb_mel_filterbank(n_mels=n_mels)).to(device))


def fbank(audio: torch.Tensor, n_mels: int = 80,
          frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T] 16 kHz waveform → [B, 1 + T//160, n_mels] log-mel filterbank
    with speechbrain ``Fbank`` + ``InputNormalization(sentence)`` semantics:
    25 ms periodic-Hamming frames over zero centre padding, power spectrum,
    HTK-mel triangles, 10·log10 with amin 1e-10 and a per-utterance top_db
    80 floor, then per-utterance mean subtraction. ``frame_mask`` [B, frames]
    restricts the utterance max and mean to the valid frames of padded
    rows."""
    if audio.ndim == 1:
        audio = audio[None]
    audio = audio.to(torch.float32)
    n_frames = 1 + audio.shape[-1] // 160
    x = F.pad(audio, (200, 200))
    frames = x.unfold(-1, 400, 160)[:, :n_frames]       # [B, F, 400]
    cos_m, sin_m, melfb = _fbank_matrices(n_mels, audio.device)
    with full_f32():
        re = frames @ cos_m
        im = frames @ sin_m
        m = (re * re + im * im) @ melfb
    logm = 10.0 * torch.log10(torch.clamp(m, min=1e-10))
    if frame_mask is None:
        utt_max = torch.amax(logm, dim=(1, 2), keepdim=True)
    else:
        utt_max = torch.amax(
            torch.where(frame_mask[..., None] > 0, logm,
                        torch.tensor(-float("inf"), device=logm.device)),
            dim=(1, 2), keepdim=True)
    logm = torch.maximum(logm, utt_max - 80.0)
    if frame_mask is None:
        return logm - logm.mean(dim=1, keepdim=True)
    w = frame_mask[..., None]
    denom = torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
    return logm - (logm * w).sum(dim=1, keepdim=True) / denom


# ------------------------------------------------------------------ weights

def init_ecapa_params(seed: int, dims: EcapaDims = EcapaDims()
                      ) -> Dict[str, Any]:
    """Seeded random init in the JAX package's layout and distributions
    (conv weights normal × (k·cin)^-0.5, zero biases, identity batch
    norms), as numpy, drawn from a CPU ``torch.Generator`` so one seed gives
    the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)

    def conv(k, cin, cout):
        return {"w": (torch.randn((k, cin, cout), generator=gen)
                      * (k * cin) ** -0.5).numpy(),
                "b": np.zeros((cout,), np.float32)}

    def bn(c):
        return {"g": np.ones((c,), np.float32), "b": np.zeros((c,), np.float32),
                "mean": np.zeros((c,), np.float32),
                "var": np.ones((c,), np.float32)}

    C, S, A, M = (dims.channels, dims.res2net_scale, dims.attention_channels,
                  dims.mfa_channels)
    p: Dict[str, Any] = {
        "conv1": conv(5, dims.n_mels, C), "bn1": bn(C), "blocks": [],
        "mfa": conv(1, 3 * C, M), "mfa_bn": bn(M),
        "asp": {"conv1": conv(1, 3 * M, A), "bn1": bn(A),
                "conv2": conv(1, A, M)},
        "asp_bn": bn(2 * M),
        "fc": conv(1, 2 * M, dims.embedding_dim),
    }
    width = C // S
    for _ in dims.dilations:
        p["blocks"].append({
            "conv_in": conv(1, C, C), "bn_in": bn(C),
            "res2": [conv(3, width, width) for _ in range(S - 1)],
            "res2_bn": [bn(width) for _ in range(S - 1)],
            "conv_out": conv(1, C, C), "bn_out": bn(C),
            "se": {"fc1": conv(1, C, A), "fc2": conv(1, A, C)},
        })
    return p


def ecapa_from_jax_params(tree: Dict[str, Any], device="cuda"
                          ) -> Dict[str, Any]:
    """The JAX package's ECAPA pytree (numpy leaves) → the same tree of f32
    tensors on ``device``, conv ``w`` [k, in, out] turned to [out, in, k]."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        a = np.asarray(node, np.float32)
        if key == "w":
            a = np.transpose(a, (2, 1, 0))
        return torch.from_numpy(np.array(a)).to(device)
    return walk(tree)


def init_ecapa(dims: EcapaDims = EcapaDims(), seed: int = 0,
               device="cuda") -> Dict[str, Any]:
    """``init_ecapa_params`` placed on ``device``."""
    return ecapa_from_jax_params(init_ecapa_params(seed, dims), device)


# ------------------------------------------------------------------ ops
# Activations are [B, C, T] (torch conv layout) throughout.

def _conv(x, p, dilation=1):
    k = p["w"].shape[-1]
    return F.conv1d(x, p["w"], p["b"], padding=dilation * (k - 1) // 2,
                    dilation=dilation)


def _bn(x, p, eps=1e-5):
    inv = torch.rsqrt(p["var"] + eps)
    return ((x - p["mean"][:, None]) * inv[:, None] * p["g"][:, None]
            + p["b"][:, None])


def _tdnn(x, conv_p, bn_p, dilation=1):
    """speechbrain TDNNBlock: conv → ReLU → BatchNorm (norm last)."""
    return _bn(F.relu(_conv(x, conv_p, dilation)), bn_p)


def _masked_mean_std(x, mask, eps=1e-12):
    """x [B, C, T], mask [B, T] → (mean, std) [B, C] over valid frames."""
    m = mask[:, None, :]
    denom = torch.clamp(m.sum(dim=2), min=1.0)
    mean = (x * m).sum(dim=2) / denom
    var = ((x - mean[:, :, None]) ** 2 * m).sum(dim=2) / denom
    return mean, torch.sqrt(torch.clamp(var, min=eps))


def _se_block(x, p, mask):
    m = mask[:, None, :]
    denom = torch.clamp(m.sum(dim=2, keepdim=True), min=1.0)
    s = (x * m).sum(dim=2, keepdim=True) / denom
    s = F.relu(_conv(s, p["fc1"]))
    s = torch.sigmoid(_conv(s, p["fc2"]))
    return x * s


def _res2_block(x, blk, mask, dilation):
    S = len(blk["res2"]) + 1
    y = _tdnn(x, blk["conv_in"], blk["bn_in"])
    chunks = torch.chunk(y, S, dim=1)
    outs = [chunks[0]]
    prev = None
    for i in range(1, S):
        h = chunks[i] if prev is None else chunks[i] + prev
        h = _tdnn(h, blk["res2"][i - 1], blk["res2_bn"][i - 1], dilation)
        outs.append(h)
        prev = h
    y = _tdnn(torch.cat(outs, dim=1), blk["conv_out"], blk["bn_out"])
    return x + _se_block(y, blk["se"], mask)


@torch.no_grad()
def ecapa_embed(params: Dict[str, Any], audio: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                dims: EcapaDims = EcapaDims()) -> torch.Tensor:
    """[B, T] waveform (+ per-row valid sample counts) → [B, D] embeddings.
    The frame mask derives from ``lengths`` so one padded batch replaces the
    reference's per-segment loop (back/api.py:928-946)."""
    if audio.ndim == 1:
        audio = audio[None]
    B, T = audio.shape
    Fn = 1 + T // 160          # torch.stft center=True frame count
    dev = audio.device
    if lengths is None:
        mask = torch.ones((B, Fn), dtype=torch.float32, device=dev)
    else:
        # speechbrain passes relative lengths: valid frames scale with the
        # row's share of the padded width (round(lengths * n_frames)).
        valid = (lengths.to(torch.int64) * Fn + T // 2) // T
        mask = (torch.arange(Fn, device=dev)[None, :]
                < valid[:, None]).to(torch.float32)
    with full_f32():
        feats = fbank(audio, dims.n_mels, frame_mask=mask) * mask[..., None]
        m3 = mask[:, None, :]
        x = _tdnn(feats.transpose(1, 2), params["conv1"], params["bn1"]) * m3
        outs: List[torch.Tensor] = []
        for blk, dilation in zip(params["blocks"], dims.dilations):
            x = _res2_block(x, blk, mask, dilation) * m3
            outs.append(x)
        x = _tdnn(torch.cat(outs, dim=1), params["mfa"], params["mfa_bn"])

        # Attentive statistics pooling with global context (speechbrain
        # ASP: TDNNBlock → tanh → conv for the attention scores).
        mean, std = _masked_mean_std(x, mask)
        Tn = x.shape[2]
        ctx = torch.cat([x, mean[:, :, None].expand(-1, -1, Tn),
                         std[:, :, None].expand(-1, -1, Tn)], dim=1)
        attn = _conv(torch.tanh(_tdnn(ctx, params["asp"]["conv1"],
                                      params["asp"]["bn1"])),
                     params["asp"]["conv2"])
        attn = torch.where(m3 > 0, attn, torch.tensor(-1e9, device=dev))
        attn = torch.softmax(attn, dim=2)
        amean = (attn * x).sum(dim=2)
        astd = torch.sqrt(torch.clamp((attn * x * x).sum(dim=2) - amean ** 2,
                                      min=1e-12))
        pooled = torch.cat([amean, astd], dim=1)[:, :, None]
        pooled = _bn(pooled, params["asp_bn"])
        return _conv(pooled, params["fc"])[:, :, 0]


# ------------------------------------------------------------ checkpoints

def convert_speechbrain_ecapa(sd: Dict[str, Any]) -> Dict[str, Any]:
    """speechbrain spkrec-ecapa-voxceleb ``embedding_model.ckpt`` state
    dict → the JAX package's pytree layout, numpy leaves. Torch Conv1d
    weights [out, in, k] → [k, in, out]; BatchNorm keeps its running
    statistics (inference mode)."""
    def np_(v):
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)

    def conv(prefix):
        w = np_(sd[f"{prefix}.weight"])
        b = sd.get(f"{prefix}.bias")
        return {"w": w.transpose(2, 1, 0),
                "b": np_(b) if b is not None else np.zeros(w.shape[0], np.float32)}

    def bn(prefix):
        return {"g": np_(sd[f"{prefix}.weight"]),
                "b": np_(sd[f"{prefix}.bias"]),
                "mean": np_(sd[f"{prefix}.running_mean"]),
                "var": np_(sd[f"{prefix}.running_var"])}

    p = {
        "conv1": conv("blocks.0.conv.conv"),
        "bn1": bn("blocks.0.norm.norm"),
        "blocks": [],
        "mfa": conv("mfa.conv.conv"),
        "mfa_bn": bn("mfa.norm.norm"),
        "asp": {"conv1": conv("asp.tdnn.conv.conv"),
                "bn1": bn("asp.tdnn.norm.norm"),
                "conv2": conv("asp.conv.conv")},
        "asp_bn": bn("asp_bn.norm"),
        # ECAPA_TDNN.fc is one speechbrain Conv1d wrapper (torch conv at
        # ".conv"), not a TDNNBlock, so one ".conv" here.
        "fc": conv("fc.conv"),
    }
    for bi in range(1, 4):
        pre = f"blocks.{bi}"
        # The res2net width comes from the checkpoint's key count.
        n_res2 = 0
        while f"{pre}.res2net_block.blocks.{n_res2}.conv.conv.weight" in sd:
            n_res2 += 1
        p["blocks"].append({
            "conv_in": conv(f"{pre}.tdnn1.conv.conv"),
            "bn_in": bn(f"{pre}.tdnn1.norm.norm"),
            "res2": [conv(f"{pre}.res2net_block.blocks.{i}.conv.conv")
                     for i in range(n_res2)],
            "res2_bn": [bn(f"{pre}.res2net_block.blocks.{i}.norm.norm")
                        for i in range(n_res2)],
            "conv_out": conv(f"{pre}.tdnn2.conv.conv"),
            "bn_out": bn(f"{pre}.tdnn2.norm.norm"),
            "se": {"fc1": conv(f"{pre}.se_block.conv1.conv"),
                   "fc2": conv(f"{pre}.se_block.conv2.conv")},
        })
    return p


def infer_ecapa_dims(params: Dict[str, Any],
                     fallback: EcapaDims = EcapaDims()) -> EcapaDims:
    """Dims recoverable from a converted pytree's shapes; the dilations come
    from ``fallback``. The production checkpoint gives exactly EcapaDims()."""
    return dataclasses.replace(
        fallback,
        n_mels=int(np.shape(params["conv1"]["w"])[1]),
        channels=int(np.shape(params["conv1"]["w"])[2]),
        mfa_channels=int(np.shape(params["mfa"]["w"])[2]),
        attention_channels=int(np.shape(params["asp"]["conv1"]["w"])[2]),
        embedding_dim=int(np.shape(params["fc"]["w"])[2]),
        res2net_scale=len(params["blocks"][0]["res2"]) + 1,
    )
