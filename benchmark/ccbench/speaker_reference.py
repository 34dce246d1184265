"""Plain PyanNet and ECAPA-TDNN in float32, the yardstick for the speaker
models' part of ``correct``.

Written from pyannote's PyanNet (SincNet with asteroid's ParamSincFB, a
bidirectional LSTM, a linear stack and a powerset classifier) and
speechbrain's ECAPA-TDNN (``Fbank`` with sentence mean normalisation,
SE-Res2Net blocks, attentive statistics pooling), in plain PyTorch, at the
semantics the port states for them: frame-validity masks from each row's
valid samples, batch norms in inference mode. It imports nothing of the
measured program: it reads the benchmark's own weight dictionaries
(``weights.pyannet_spec``, ``weights.ecapa_spec``) and the audio rows the
program's calls took. The LSTM is written out step by step.

Every product runs in IEEE float32 (TF32 off). ``tf32=True`` rounds both
operands of every product to TF32 (10-bit mantissa) first, the precision
below the float32 with TF32 off that the configuration states for both
models: that mode is the control that must come out as not correct.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ccbench.reference import ieee_f32

SR = 16000


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest TF32 value (ties to even), in float32."""
    i = x.contiguous().float().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


class Ops:
    """The products of the reference, in float32 or with TF32 operands."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return to_tf32(x) if self.tf32 else x

    def mm(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def conv1d(self, x, w, b=None, stride=1, padding=0, dilation=1):
        return F.conv1d(self.q(x), self.q(w), b, stride=stride,
                        padding=padding, dilation=dilation)


# ---------------------------------------------------------------- PyanNet

def _instance_norm(x, w, name, eps=1e-5):
    """[B, C, T] normalised over time per row and channel."""
    mean = x.mean(dim=2, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=2, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * w[f"{name}.g"][None, :, None]
            + w[f"{name}.b"][None, :, None])


def sinc_bank(low_hz, band_hz, kernel: int, min_low_hz=50.0,
              min_band_hz=50.0) -> torch.Tensor:
    """asteroid's ParamSincFB: each band gives a cos- and a sin-phase
    band-pass filter under a symmetric Hamming window, interleaved (cos0,
    sin0, cos1, ...); [2 * bands, 1, kernel]."""
    low = min_low_hz + low_hz.abs()
    high = torch.clamp(low + min_band_hz + band_hz.abs(), min_low_hz, SR / 2)
    band = (high - low)[None, :]
    n = (kernel - 1) // 2
    dev = low_hz.device
    t = (torch.arange(-n, 0, dtype=torch.float32, device=dev) / SR)[:, None]
    window = 0.54 - 0.46 * torch.cos(
        2 * math.pi * torch.arange(kernel, dtype=torch.float32, device=dev)
        / (kernel - 1))[:n, None]
    two_pi_t = 2 * math.pi * t
    lo, hi = low[None, :] * two_pi_t, high[None, :] * two_pi_t
    cos_left = (torch.sin(hi) - torch.sin(lo)) / (two_pi_t / 2) * window
    cos_f = torch.cat([cos_left, 2 * band, cos_left.flip(0)], 0) / (2 * band)
    sin_left = (torch.cos(lo) - torch.cos(hi)) / (two_pi_t / 2) * window
    sin_f = torch.cat([sin_left, torch.zeros_like(band), -sin_left.flip(0)],
                      0) / (2 * band)
    return torch.stack([cos_f, sin_f], -1).reshape(kernel, -1).T[:, None, :]


def _lstm_direction(ops, w, li: int, sfx: str, x, reverse: bool):
    """One direction of one LSTM layer over [B, T, I] → [B, T, H]; gates
    i, f, g, o as torch orders them."""
    w_ih, w_hh = w[f"lstm.weight_ih_l{li}{sfx}"], w[f"lstm.weight_hh_l{li}{sfx}"]
    bias = w[f"lstm.bias_ih_l{li}{sfx}"] + w[f"lstm.bias_hh_l{li}{sfx}"]
    B, T, _ = x.shape
    H = w_hh.shape[1]
    xin = ops.mm(x, w_ih.T) + bias
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    out = x.new_empty(B, T, H)
    steps = range(T - 1, -1, -1) if reverse else range(T)
    for t in steps:
        g = xin[:, t] + ops.mm(h, w_hh.T)
        i, f, gg, o = g.chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, t] = h
    return out


@torch.no_grad()
def pyannet_logprobs(w: Dict[str, torch.Tensor], d: dict,
                     audio: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """[B, T] waveform → [B, frames, n_classes] powerset log-probabilities."""
    ops = Ops(tf32)
    with ieee_f32():
        x = _instance_norm(audio.float()[:, None, :], w, "sincnet.wav_norm")
        bank = sinc_bank(w["sincnet.low_hz"], w["sincnet.band_hz"],
                         d["sinc_kernel"])
        x = ops.conv1d(x, bank, stride=d["sinc_stride"]).abs()
        x = F.leaky_relu(_instance_norm(F.max_pool1d(x, d["pool"]), w,
                                        "sincnet.norm0"))
        for i in (1, 2):
            x = ops.conv1d(x, w[f"sincnet.conv{i}.w"], w[f"sincnet.conv{i}.b"])
            x = F.leaky_relu(_instance_norm(F.max_pool1d(x, d["pool"]), w,
                                            f"sincnet.norm{i}"))
        x = x.transpose(1, 2)
        for li in range(d["lstm_layers"]):
            x = torch.cat([_lstm_direction(ops, w, li, "", x, False),
                           _lstm_direction(ops, w, li, "_reverse", x, True)],
                          dim=2)
        for i in range(len(d["linear_dims"])):
            x = F.leaky_relu(ops.mm(x, w[f"linear.{i}.w"]) + w[f"linear.{i}.b"])
        x = ops.mm(x, w["classifier.w"]) + w["classifier.b"]
    return F.log_softmax(x, dim=-1)


# ------------------------------------------------------------------ ECAPA

def _fbank_matrices(n_mels: int, device):
    """speechbrain's STFT as real-DFT matrices under a periodic Hamming
    window, and its Filterbank: HTK-mel triangles whose half-width is each
    centre's left gap, without area normalisation; [400, 201] twice and
    [201, n_mels]."""
    n = np.arange(400, dtype=np.float64)
    k = np.arange(201, dtype=np.float64)
    ang = 2.0 * np.pi * n[:, None] * k[None, :] / 400
    window = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / 400)
    mel = np.linspace(0.0, 2595.0 * np.log10(1 + 8000.0 / 700), n_mels + 2)
    hz = 700.0 * (10.0 ** (mel / 2595.0) - 1)
    freqs = np.linspace(0, 8000, 201)
    slope = (freqs[None, :] - hz[1:-1, None]) / np.diff(hz)[:-1, None]
    tri = np.maximum(0.0, np.minimum(slope + 1.0, 1.0 - slope))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in
            (np.cos(ang) * window[:, None], -np.sin(ang) * window[:, None],
             tri.T)]


def fbank(ops, audio, n_mels: int, mask):
    """[B, T] → [B, 1 + T // 160, n_mels]: 25 ms frames every 10 ms over
    zero centre padding, power spectrum, mel, 10 log10 (amin 1e-10) with
    an 80 dB floor under each row's maximum over its valid frames, minus
    the row's mean over its valid frames."""
    n_frames = 1 + audio.shape[-1] // 160
    frames = F.pad(audio.float(), (200, 200)).unfold(-1, 400, 160)[:, :n_frames]
    cos_m, sin_m, fb = _fbank_matrices(n_mels, audio.device)
    re, im = ops.mm(frames, cos_m), ops.mm(frames, sin_m)
    logm = 10.0 * torch.log10(ops.mm(re * re + im * im, fb).clamp_min(1e-10))
    valid = mask[..., None] > 0
    top = torch.where(valid, logm, -math.inf).amax(dim=(1, 2), keepdim=True)
    logm = torch.maximum(logm, top - 80.0)
    wm = mask[..., None]
    return logm - (logm * wm).sum(1, keepdim=True) / wm.sum(1, keepdim=True).clamp_min(1.0)


def _conv(ops, w, name, x, dilation=1):
    k = w[f"{name}.w"].shape[-1]
    return ops.conv1d(x, w[f"{name}.w"], w[f"{name}.b"],
                      padding=dilation * (k - 1) // 2, dilation=dilation)


def _bn(w, name, x, eps=1e-5):
    return ((x - w[f"{name}.mean"][:, None])
            * torch.rsqrt(w[f"{name}.var"] + eps)[:, None]
            * w[f"{name}.g"][:, None] + w[f"{name}.b"][:, None])


def _tdnn(ops, w, conv, bn, x, dilation=1):
    """speechbrain's TDNNBlock: convolution, ReLU, batch norm."""
    return _bn(w, bn, F.relu(_conv(ops, w, conv, x, dilation)))


def _masked_mean(x, mask):
    m = mask[:, None, :]
    return (x * m).sum(2) / m.sum(2).clamp_min(1.0)


@torch.no_grad()
def ecapa_embeddings(w: Dict[str, torch.Tensor], d: dict, audio: torch.Tensor,
                     lengths: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """[B, T] waveform with each row's valid samples → [B, embedding_dim].
    A row's valid frames are its share of the frames, rounded, as
    speechbrain's relative lengths give them."""
    ops = Ops(tf32)
    B, T = audio.shape
    Fn = 1 + T // 160
    valid = (lengths.long() * Fn + T // 2) // T
    mask = (torch.arange(Fn, device=audio.device)[None, :]
            < valid[:, None]).float()
    m3 = mask[:, None, :]
    with ieee_f32():
        x = (fbank(ops, audio, d["n_mels"], mask) * mask[..., None]).transpose(1, 2)
        x = _tdnn(ops, w, "conv1", "bn1", x) * m3
        outs = []
        for bi, dil in enumerate(d["dilations"]):
            p = f"blocks.{bi}"
            y = _tdnn(ops, w, f"{p}.conv_in", f"{p}.bn_in", x)
            parts = list(torch.chunk(y, d["res2net_scale"], dim=1))
            res, prev = [parts[0]], None
            for j in range(1, d["res2net_scale"]):
                h = parts[j] if prev is None else parts[j] + prev
                prev = _tdnn(ops, w, f"{p}.res2.{j - 1}", f"{p}.res2_bn.{j - 1}",
                             h, dil)
                res.append(prev)
            y = _tdnn(ops, w, f"{p}.conv_out", f"{p}.bn_out", torch.cat(res, 1))
            s = _masked_mean(y, mask)[:, :, None]
            s = torch.sigmoid(_conv(ops, w, f"{p}.se.fc2",
                                    F.relu(_conv(ops, w, f"{p}.se.fc1", s))))
            x = (x + y * s) * m3
            outs.append(x)
        x = _tdnn(ops, w, "mfa", "mfa_bn", torch.cat(outs, 1))
        mean = _masked_mean(x, mask)
        var = _masked_mean((x - mean[:, :, None]) ** 2, mask)
        std = var.clamp_min(1e-12).sqrt()
        Tn = x.shape[2]
        ctx = torch.cat([x, mean[:, :, None].expand(-1, -1, Tn),
                         std[:, :, None].expand(-1, -1, Tn)], 1)
        a = _conv(ops, w, "asp.conv2",
                  torch.tanh(_tdnn(ops, w, "asp.conv1", "asp.bn1", ctx)))
        a = torch.softmax(torch.where(m3 > 0, a, torch.full_like(a, -1e9)), 2)
        amean = (a * x).sum(2)
        astd = ((a * x * x).sum(2) - amean ** 2).clamp_min(1e-12).sqrt()
        pooled = _bn(w, "asp_bn", torch.cat([amean, astd], 1)[:, :, None])
        return _conv(ops, w, "fc", pooled)[:, :, 0]
