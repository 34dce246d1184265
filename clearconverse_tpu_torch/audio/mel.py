"""Whisper-exact log-mel spectrogram frontend in PyTorch.

N_FFT=400, hop 160, periodic Hann window, reflect padding, power spectrum
with the trailing frame dropped, slaney-normalized mel filterbank, log10
with an 8 dB dynamic-range clamp, (x+4)/4 scaling — the JAX package's
audio/mel.py. Frames are projected with dense cos/sin DFT matrices in f32
(TF32 off), the form the JAX package runs at HIGHEST precision.
``log_mel_auto`` runs the hand-written CUDA kernel (ops/logmel.py) on a
CUDA tensor and this plain form on a CPU tensor.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from clearconverse_tpu_torch.utils.precision import full_f32

N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
SAMPLE_RATE = 16000


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False): linear to 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, f / f_sp)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@lru_cache(maxsize=4)
def mel_filterbank(sr: int = SAMPLE_RATE, n_fft: int = N_FFT, n_mels: int = N_MELS) -> np.ndarray:
    """[n_freq, n_mels] slaney-normalized triangular filterbank, equal to
    librosa.filters.mel(sr, n_fft, n_mels).T (whisper assets/mel_filters.npz)."""
    fftfreqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:] - mel_pts[:-2])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)  # [n_freq, n_mels]


@lru_cache(maxsize=2)
def _dft_matrices(n_fft: int = N_FFT):
    """Windowed real-DFT projection matrices [n_fft, n_freq] (f32)."""
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    ang = 2.0 * np.pi * n[:, None] * k[None, :] / n_fft
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))  # periodic Hann
    cos_m = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_m = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_m, sin_m


@lru_cache(maxsize=8)
def device_matrices(device: torch.device, n_mels: int = N_MELS):
    """(cos [400, 201], sin [400, 201], filterbank [201, n_mels]) as f32
    tensors on ``device``, row-major, uploaded once per device: the plain
    version's operands (K1 takes ops/logmel.py::kernel_operands)."""
    cos_m, sin_m = _dft_matrices()
    fb = mel_filterbank(n_mels=n_mels)     # a transposed, column-major array
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (cos_m, sin_m, fb))


def frame_signal(audio: torch.Tensor, n_fft: int = N_FFT,
                 hop: int = HOP_LENGTH) -> torch.Tensor:
    """Reflect-pad and frame ``[B, T]`` → ``[B, 1 + T//hop, n_fft]``
    (torch.stft center=True framing), as a strided view."""
    pad = n_fft // 2
    x = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return x.unfold(-1, n_fft, hop)


def mel_power(audio: torch.Tensor, n_mels: int = N_MELS) -> torch.Tensor:
    """``[B, T]`` waveform → ``[B, T//hop, n_mels]`` mel power, in f32:
    reflect pad, frame, windowed DFT matmuls, power, mel projection."""
    frames = frame_signal(audio.float())[:, :-1, :]   # whisper drops the last frame
    cos_m, sin_m, fb = device_matrices(audio.device, n_mels)
    with full_f32():
        re = torch.matmul(frames, cos_m)
        im = torch.matmul(frames, sin_m)
        return torch.matmul(re * re + im * im, fb)


def log_mel_from_power(mel: torch.Tensor) -> torch.Tensor:
    """``[B, F, n_mels]`` mel power → ``[B, n_mels, F]`` whisper log-mel:
    log10 with a 1e-10 floor, a per-item clamp to max - 8, (x+4)/4."""
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(
        log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(1, 2)


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = N_MELS) -> torch.Tensor:
    """``[B, T]`` float32 waveform @16 kHz → ``[B, n_mels, n_frames]`` log-mel
    (the plain PyTorch form, on any device)."""
    if audio.ndim == 1:
        audio = audio[None, :]
    return log_mel_from_power(mel_power(audio, n_mels))


def log_mel_auto(audio: torch.Tensor, n_mels: int = N_MELS) -> torch.Tensor:
    """``[B, T]`` → ``[B, n_mels, F]`` log-mel with the mel power from
    ops/logmel.mel_power: the fused CUDA kernel K1 for a CUDA tensor, the
    plain form for a CPU tensor."""
    from clearconverse_tpu_torch.ops.logmel import mel_power as k1_mel_power
    if audio.ndim == 1:
        audio = audio[None, :]
    return log_mel_from_power(k1_mel_power(audio, n_mels))


def pad_or_trim(audio: torch.Tensor, length: int) -> torch.Tensor:
    """Whisper's pad_or_trim on the last axis (zero padding)."""
    t = audio.shape[-1]
    if t >= length:
        return audio[..., :length]
    return F.pad(audio, (0, length - t))
