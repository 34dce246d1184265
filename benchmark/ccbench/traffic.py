"""The audio the traffic kinds (``kinds/<kind>.py``) write: files drawn
from ``--seed`` by the parameters of a mix file
(``benchmark/traffic/<name>.json``).

The conversation is the port's synthetic two-voice speech (a copy of
``pipeline/dev_backend.synth_conversation_speech``): two harmonic voices
(f0 120 and 210 Hz, -12 dB/octave tilt) in the same 12 s layout of turns,
with 10 ms raised-cosine edges. Each file tiles it to its length and adds
band-limited noise (a copy of ``bench._bl_noise``). The seed draws the
voices' phases and the noise; lengths and layout are the mix's, so every
seed asks for the same work.
"""

from __future__ import annotations

import wave

import numpy as np

SR = 16000
TURN_S = 12.0


def conversation(rng: np.random.Generator, f0_low: float = 120.0,
                 f0_high: float = 210.0) -> np.ndarray:
    """12 s of two voices: low 0-3, 6.2-8.9, 9.5-11.5 s; high 3.5-6,
    9.5-11.5 s (both at once in the last turn)."""
    t = np.arange(int(TURN_S * SR)) / SR

    def voice(f0: float) -> np.ndarray:
        x = np.zeros_like(t)
        for n in range(1, 13):
            x += np.sin(2 * np.pi * n * f0 * t + rng.uniform(0, 2 * np.pi)) / n ** 2
        return (x / np.max(np.abs(x))).astype(np.float32)

    low, high = 0.5 * voice(f0_low), 0.5 * voice(f0_high)

    def gate(a: float, b: float) -> np.ndarray:
        y = np.clip(np.minimum((t - a) / 0.01, (b - t) / 0.01), 0.0, 1.0)
        return (0.5 - 0.5 * np.cos(np.pi * y)).astype(np.float32)

    x = (low * (gate(0, 3) + gate(6.2, 8.9) + gate(9.5, 11.5))
         + high * (gate(3.5, 6) + gate(9.5, 11.5)))
    return x.astype(np.float32)


def band_limited_noise(rng: np.random.Generator, n: int,
                       sigma: float) -> np.ndarray:
    """White noise through an 8-tap box filter, scaled to std ``sigma``."""
    w = rng.standard_normal(n + 8).astype(np.float32)
    c = np.cumsum(w, dtype=np.float64)
    b = ((c[8:] - c[:-8]) / 8.0)[:n]
    return (b * (sigma / b.std())).astype(np.float32)


def write_wav(path: str, x: np.ndarray) -> None:
    """16 kHz mono 16-bit PCM."""
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as fh:
        fh.setnchannels(1)
        fh.setsampwidth(2)
        fh.setframerate(SR)
        fh.writeframes(pcm.tobytes())


def make_file(rng: np.random.Generator, seconds: float,
              noise_sigma: float) -> np.ndarray:
    base = conversation(rng)
    reps = int(np.ceil(seconds / TURN_S))
    x = np.tile(base, reps)[: int(seconds * SR)]
    return x + band_limited_noise(rng, x.shape[0], noise_sigma)
