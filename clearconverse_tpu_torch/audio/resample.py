"""Windowed-sinc polyphase resampler.

torchaudio's ``Resample`` math (the reference caches one per source rate,
back/api.py:826-830): a bank of ``new`` polyphase sinc filters (Hann-
windowed, rolloff 0.99, filter width 6), applied as one strided
convolution. The bank is built on the host in float64 once per (orig, new)
pair; the convolution runs in IEEE f32.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from clearconverse_tpu_torch.utils.precision import full_f32


@lru_cache(maxsize=32)
def _kernel_bank(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                 rolloff: float = 0.99) -> tuple:
    """Polyphase filter bank [new_freq, 1, K] plus pad width, as numpy f32."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)

    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx[None, :]
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2
    t *= math.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel *= window * (base_freq / orig_freq)
    return kernel[:, None, :].astype(np.float32), width


def resample(waveform: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """Resample ``[..., T]`` from orig_freq to new_freq on the waveform's
    device. Output length is ``ceil(new_freq * T / orig_freq)``, as
    torchaudio gives it."""
    if orig_freq == new_freq:
        return waveform
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // gcd, int(new_freq) // gcd
    kernel_np, width = _kernel_bank(orig, new, lowpass_filter_width, rolloff)
    kernel = torch.from_numpy(kernel_np).to(waveform.device)

    shape = waveform.shape
    length = shape[-1]
    x = waveform.reshape(-1, 1, length).to(torch.float32)
    x = F.pad(x, (width, width + orig))
    with full_f32():
        # [B, new, frames]: each output channel is one polyphase branch.
        y = F.conv1d(x, kernel, stride=orig)
    frames = y.shape[-1]
    y = y.transpose(1, 2).reshape(-1, frames * new)
    target_len = int(math.ceil(new * length / orig))
    y = y[:, :target_len]
    return y.reshape(shape[:-1] + (target_len,))
