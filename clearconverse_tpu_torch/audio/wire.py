"""8-bit mu-law wire for host→device audio uploads (opt-in, ``wire_bits=8``).

mu-law (G.711's companding curve, mu = 255) halves the bytes of int16 at
≈38 dB SNR on speech. It is lossy, so it is off by default; the default wire
is the lossless delta packing of audio/pack.py. The host encodes with numpy;
the device expands inside the gate (audio/denoise.gate_normalize_u8) with
the exact inverse and re-encodes the gated audio for the download.
"""

from __future__ import annotations

import numpy as np
import torch

MU = 255.0

# Midtread quantizer: code = round(y*127)+128, so y = 0 maps to code 128
# exactly and decodes to exactly 0.0 (a digitally silent row stays silent
# after peak normalization).
_STEPS = 127.0


def mulaw_encode_np(x: np.ndarray) -> np.ndarray:
    """float in [-1, 1] → uint8 mu-law code."""
    x = np.clip(x, -1.0, 1.0)
    y = np.sign(x) * np.log1p(MU * np.abs(x)) / np.log1p(MU)
    return np.clip(np.round(y * _STEPS) + 128.0, 0, 255).astype(np.uint8)


def mulaw_encode_i16_np(w: np.ndarray) -> np.ndarray:
    """int16 waveform → mu-law codes of the peak-prescaled signal (exactly
    ``mulaw_encode_np((w/32768) / (max|w|/32768))``) through a 65536-entry
    table for rows longer than the table."""
    if len(w) == 0:
        return np.zeros(0, np.uint8)
    wi = w.astype(np.int32)
    m = float(max(int(np.max(np.abs(wi))), 1)) / 32768.0
    if len(w) <= 65536:
        x = wi.astype(np.float32) / np.float32(32768.0)
        return mulaw_encode_np(x / m)
    grid = np.arange(-32768, 32768, dtype=np.float32) / np.float32(32768.0)
    lut = mulaw_encode_np(grid / m)
    return lut[wi + 32768]


def mulaw_decode_np(u: np.ndarray) -> np.ndarray:
    """uint8 mu-law code → float32 in [-1, 1] (host mirror of the device
    expand)."""
    y = np.clip((u.astype(np.float32) - 128.0) / _STEPS, -1.0, 1.0)
    return np.sign(y) * ((1.0 + MU) ** np.abs(y) - 1.0) / MU


def mulaw_expand(u: torch.Tensor) -> torch.Tensor:
    """uint8 [B, T] → float32 in [-1, 1], on the tensor's device."""
    y = torch.clamp((u.to(torch.float32) - 128.0) / _STEPS, -1.0, 1.0)
    return torch.sign(y) * (torch.pow(1.0 + MU, torch.abs(y)) - 1.0) / MU


def mulaw_encode(x: torch.Tensor) -> torch.Tensor:
    """float32 [B, T] in [-1, 1] → uint8 mu-law, on the tensor's device (the
    download leg of the 8-bit wire)."""
    x = torch.clamp(x, -1.0, 1.0)
    y = torch.sign(x) * torch.log1p(MU * torch.abs(x)) / float(np.log1p(MU))
    return torch.clamp(torch.round(y * _STEPS) + 128.0, 0, 255).to(torch.uint8)
