"""Stationary spectral-gating noise reduction, batched on the device.

The noisereduce algorithm the reference applies in ``load_audio``
(back/api.py:832, stationary, prop_decrease = the config's amount) and in
profile building: per-frequency noise statistics over the whole clip, a dB
threshold at mean + 1.5·std, triangular smoothing of the binary gate over
(time, frequency), a linear blend by ``prop_decrease``, inverse STFT.

The STFT and its inverse run as windowed real-DFT matmuls (N_FFT 1024, hop
256), the JAX package's default path, in IEEE f32 (TF32 off): the reference
runs them at highest precision.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from clearconverse_tpu_torch.utils.precision import full_f32

N_FFT = 1024
HOP = 256
_N_STD_THRESH = 1.5
_FREQ_SMOOTH_HZ = 500
_TIME_SMOOTH_MS = 50


@lru_cache(maxsize=2)
def _smoothing_filter(sr: int) -> np.ndarray:
    """noisereduce's triangular (freq × time) smoothing kernel, sum-normalized."""
    n_grad_freq = int(_FREQ_SMOOTH_HZ / (sr / (N_FFT / 2)))
    n_grad_time = int(_TIME_SMOOTH_MS / ((HOP / sr) * 1000))

    def ramp(n):
        v = np.concatenate([np.linspace(0, 1, n + 1, endpoint=False),
                            np.linspace(1, 0, n + 2)])
        return v[1:-1]

    filt = np.outer(ramp(n_grad_freq), ramp(n_grad_time))
    return (filt / filt.sum()).astype(np.float32)


def _hann(n: int) -> np.ndarray:
    i = np.arange(n)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))).astype(np.float32)


@lru_cache(maxsize=2)
def _gate_dft_matrices():
    """Windowed real-DFT/IDFT matrices [N_FFT, N_FFT//2+1]: the forward pair
    folds the analysis window; the inverse pair folds irfft's conjugate-
    symmetry weights and the synthesis window."""
    N = N_FFT
    n = np.arange(N, dtype=np.float64)
    k = np.arange(N // 2 + 1, dtype=np.float64)
    ang = 2.0 * np.pi * n[:, None] * k[None, :] / N
    window = _hann(N).astype(np.float64)
    cos_m = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_m = (-np.sin(ang) * window[:, None]).astype(np.float32)
    wk = np.where((k == 0) | (k == N // 2), 1.0, 2.0) / N
    icos = (np.cos(ang) * wk[None, :] * window[:, None]).astype(np.float32)
    isin = (-np.sin(ang) * wk[None, :] * window[:, None]).astype(np.float32)
    return cos_m, sin_m, icos, isin


@lru_cache(maxsize=8)
def _device_matrices(device: torch.device):
    return tuple(torch.from_numpy(m).to(device) for m in _gate_dft_matrices())


def _ola(frames_windowed: torch.Tensor, length: int) -> torch.Tensor:
    """Overlap-add of synthesis-windowed frames [B, n_frames, N_FFT] with
    window-square normalization → [B, length], as N_FFT//HOP shifted block
    adds."""
    B, n_frames, _ = frames_windowed.shape
    window = torch.from_numpy(_hann(N_FFT)).to(frames_windowed.device)
    kb = N_FFT // HOP                       # 4 overlapping blocks per sample
    fb = frames_windowed.reshape(B, n_frames, kb, HOP)
    wb = (window * window).reshape(kb, HOP)
    out_b = sum(F.pad(fb[:, :, k, :], (0, 0, k, kb - 1 - k)) for k in range(kb))
    env_b = sum(F.pad(wb[k].expand(n_frames, HOP), (0, 0, k, kb - 1 - k))
                for k in range(kb))
    out = out_b.reshape(B, -1) / torch.clamp(env_b.reshape(-1), min=1e-8)[None, :]
    pad = N_FFT // 2
    return out[:, pad: pad + length]


def spectral_gate(audio: torch.Tensor, sr: int = 16000,
                  prop_decrease: float = 0.5,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stationary spectral gating over [B, T] (or [T]) waveforms.

    ``mask`` (optional [B, T] 0/1) marks the valid samples of padded rows so
    padding does not enter the noise statistics."""
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[None, :]
    audio = audio.to(torch.float32)
    B, length = audio.shape
    with full_f32():
        pad = N_FFT // 2
        xp = F.pad(audio, (pad, pad))
        n_frames = 1 + length // HOP
        # Frames as shifted slices of HOP blocks (N_FFT = 4·HOP).
        kb = N_FFT // HOP
        n_blocks = n_frames - 1 + kb
        xb = xp[:, : n_blocks * HOP].reshape(B, n_blocks, HOP)
        frames = torch.cat([xb[:, k: k + n_frames] for k in range(kb)],
                           dim=-1)                               # [B,F,N]
        cos_m, sin_m, icos, isin = _device_matrices(audio.device)
        re = frames @ cos_m
        im = frames @ sin_m
        del frames
        # 20·log10(max(|X|, 1e-20)): a 1e-40 power floor is subnormal in f32.
        mag_db = 20.0 * torch.log10(
            torch.clamp(torch.sqrt(re * re + im * im), min=1e-20))

        if mask is not None:
            # '<=': the centre-padded STFT has 1 + n_valid//HOP frames that
            # touch valid samples.
            valid = ((torch.arange(n_frames, device=audio.device) * HOP)[None, :]
                     <= mask.sum(-1, keepdim=True))
            w = valid[:, :, None].to(mag_db.dtype)
            denom = torch.clamp(w.sum(1, keepdim=True), min=1.0)
            mean_db = (mag_db * w).sum(1, keepdim=True) / denom
            var_db = ((mag_db - mean_db) ** 2 * w).sum(1, keepdim=True) / denom
        else:
            mean_db = mag_db.mean(1, keepdim=True)
            var_db = mag_db.var(1, keepdim=True, unbiased=False)
        noise_thresh = mean_db + torch.sqrt(var_db) * _N_STD_THRESH
        gate = (mag_db > noise_thresh).to(torch.float32)
        del mag_db

        # The triangular kernel is rank-1: smooth over time, then frequency,
        # as shifted-slice adds with zero boundaries.
        filt = _smoothing_filter(sr)
        rf, rt = filt[:, 0], filt[0, :]
        scale = filt.sum() / max(float(rf.sum() * rt.sum()), 1e-30)
        Fr, K = gate.shape[1], gate.shape[2]
        ct = len(rt) // 2
        gp = F.pad(gate, (0, 0, ct, len(rt) - 1 - ct))
        gate = sum(float(w) * gp[:, i: i + Fr, :] for i, w in enumerate(rt))
        cf = len(rf) // 2
        gp = F.pad(gate, (cf, len(rf) - 1 - cf))
        gate = sum(float(w) * gp[:, :, i: i + K] for i, w in enumerate(rf))
        del gp
        gate = gate * float(scale)
        gate = gate * prop_decrease + (1.0 - prop_decrease)

        out_frames = (re * gate) @ icos.T + (im * gate) @ isin.T
        out = _ola(out_frames, length)
    if mask is not None:
        out = out * mask
    return out[0] if squeeze else out


def valid_mask(T: int, n_valid: torch.Tensor) -> torch.Tensor:
    """[B] valid lengths → [B, T] 0/1 f32 mask, built on n_valid's device."""
    return (torch.arange(T, device=n_valid.device)[None, :]
            < n_valid[:, None]).to(torch.float32)


def peak_normalize(audio: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Peak normalization with the reference's epsilon (back/api.py:835)."""
    peak = torch.amax(torch.abs(audio), dim=-1, keepdim=True)
    return audio / (peak + eps)


def spectral_gate_normalized(audio: torch.Tensor, prop_decrease: float,
                             n_valid: torch.Tensor,
                             sr: int = 16000) -> torch.Tensor:
    """Gate + peak-normalize of [B, T] rows with ``n_valid`` [B] valid
    samples each."""
    return peak_normalize(spectral_gate(
        audio, sr, prop_decrease, valid_mask(audio.shape[-1], n_valid)))


def gate_normalize_i16(q: torch.Tensor, prop_decrease: float,
                       n_valid: torch.Tensor, sr: int = 16000,
                       denoise: bool = True):
    """int16 [K, T] in (zeros past each row's n_valid) → (f32 gated +
    normalized, int16 of it for the download). The caller pre-scales float
    rows to their own peak (the gate is scale-invariant and the output is
    peak-normalized); the f32 result stays on the device as the AudioStore
    batch."""
    x = q.to(torch.float32) / 32768.0
    if denoise:
        y = spectral_gate_normalized(x, prop_decrease, n_valid, sr)
    else:
        y = peak_normalize(x)
    q_out = torch.clamp(torch.round(y * 32767.0), -32768, 32767).to(torch.int16)
    return y, q_out
