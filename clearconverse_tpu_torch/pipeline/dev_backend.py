"""Deterministic weight-free model backend (dev/demo mode and tests).

Implements the ModelBundle interface with signal-processing stand-ins: two
synthetic "speakers" are distinguished by frequency band (low ≈ 300 Hz vs
high ≈ 2000 Hz), so diarization, profiles, overlap separation and speaker
matching all genuinely function — without any trained weights. A copy of
the JAX package's pipeline/dev_backend.py; ``craft_pyannet_freq_params``
returns the port's PyanNet weights.
"""

from typing import List, Optional, Sequence

import numpy as np

SR = 16000
LOW, HIGH = 300.0, 2000.0


def band_energy(clip: np.ndarray, lo: float, hi: float, sr: int = SR) -> float:
    if len(clip) < 8:
        return 0.0
    spec = np.abs(np.fft.rfft(clip)) ** 2
    freqs = np.fft.rfftfreq(len(clip), 1 / sr)
    return float(spec[(freqs >= lo) & (freqs < hi)].sum())


class DevModels:
    frame_hop_seconds = 0.1

    def __init__(self):
        self._loaded = False
        self.transcribe_calls: List[List[str]] = []  # prompts per batch call
        self.embed_calls = 0                         # embed_batch dispatches
        self.echo_prompt = False

    def models_are_loaded(self):
        return self._loaded

    def load_with_progress(self, cb=None):
        for pct, msg in [(10, "sep"), (40, "whisper"), (70, "speakers"),
                         (100, "Models loaded")]:
            if cb:
                cb(pct, msg)
        self._loaded = True
        return True

    # -- embeddings: [low-energy, high-energy] direction ------------------
    def embed_batch(self, audio: np.ndarray,
                    lengths: Optional[np.ndarray] = None) -> np.ndarray:
        self.embed_calls += 1
        out = np.zeros((len(audio), 4), np.float32)
        for i, row in enumerate(audio):
            n = int(lengths[i]) if lengths is not None else len(row)
            clip = row[:n]
            lo = band_energy(clip, 100, 800)
            hi = band_energy(clip, 1200, 3500)
            v = np.array([lo, hi, 1e-6, 1e-6], np.float32)
            out[i] = v / (np.linalg.norm(v) + 1e-12)
        return out

    # -- segmentation: slot 0 = low speaker, slot 1 = high ----------------
    def segment_frames(self, audio: np.ndarray) -> np.ndarray:
        hop = int(self.frame_hop_seconds * SR)
        B, T = audio.shape
        F = T // hop
        out = np.zeros((B, F, 3), np.float32)
        for b in range(B):
            for f in range(F):
                fr = audio[b, f * hop : (f + 1) * hop]
                lo = band_energy(fr, 100, 800)
                hi = band_energy(fr, 1200, 3500)
                total = band_energy(fr, 0, 8000) + 1e-9
                out[b, f, 0] = 1.0 if lo / total > 0.25 and lo > 1e-3 else 0.0
                out[b, f, 1] = 1.0 if hi / total > 0.25 and hi > 1e-3 else 0.0
        return out

    # -- separation: split by frequency band ------------------------------
    def separate_batch(self, audio: np.ndarray,
                       lengths: Optional[np.ndarray] = None) -> np.ndarray:
        B, T = audio.shape
        out = np.zeros((B, T, 2), np.float32)
        for b in range(B):
            spec = np.fft.rfft(audio[b])
            freqs = np.fft.rfftfreq(T, 1 / SR)
            low_mask = freqs < 1000
            out[b, :, 0] = np.fft.irfft(spec * low_mask, n=T)
            out[b, :, 1] = np.fft.irfft(spec * ~low_mask, n=T)
        return out

    # -- transcription: deterministic content token -----------------------
    def transcribe_batch(self, audio: np.ndarray, prompts: Sequence[str],
                         temperature: float = 0.0) -> List[str]:
        self.transcribe_calls.append(list(prompts))
        texts = []
        for row, prompt in zip(audio, prompts):
            lo = band_energy(row, 100, 800)
            hi = band_energy(row, 1200, 3500)
            kind = "low" if lo >= hi else "high"
            n = int(np.sum(np.abs(row) > 1e-4) / SR * 10)
            if self.echo_prompt:
                texts.append(f"[{prompt}]{kind}{n}")
            else:
                texts.append(f"{kind} speech {n}")
        return texts


def synth_conversation() -> np.ndarray:
    """12 s: L(0-3), H(3.5-6), L(6.2-8.9), L+H overlap (9.5-11.5).
    The 0.6 s gap before the overlap keeps the last L segment un-merged
    (merge_gap_threshold is 0.5)."""
    t = np.arange(12 * SR) / SR
    low = 0.5 * np.sin(2 * np.pi * LOW * t)
    high = 0.5 * np.sin(2 * np.pi * HIGH * t)

    def g(a, b):
        return ((t >= a) & (t < b)).astype(np.float32)

    x = (low * (g(0, 3) + g(6.2, 8.9) + g(9.5, 11.5))
         + high * (g(3.5, 6) + g(9.5, 11.5)))
    return x.astype(np.float32)


def synth_conversation_speech(f0_low: float = 120.0, f0_high: float = 210.0,
                              seed: int = 0) -> np.ndarray:
    """Speech-SHAPED variant of :func:`synth_conversation` — same 12 s
    two-speaker segment layout, but each speaker is a harmonic series with
    a −12 dB/octave spectral tilt (real voiced speech's glottal rolloff)
    and every segment edge is a 10 ms raised-cosine ramp (real speech has
    no instantaneous onsets).

    Band analysis still separates the two speakers: f0 120 Hz keeps most
    energy <600 Hz, f0 210 Hz spreads harmonics into the 1200+ band via its
    tilt."""
    t = np.arange(12 * SR) / SR
    rng = np.random.default_rng(seed)

    def voice(f0: float) -> np.ndarray:
        x = np.zeros_like(t)
        for n in range(1, 13):
            x += np.sin(2 * np.pi * n * f0 * t
                        + rng.uniform(0, 2 * np.pi)) / n ** 2
        return (x / np.max(np.abs(x))).astype(np.float32)

    low, high = 0.5 * voice(f0_low), 0.5 * voice(f0_high)
    ramp = 0.01                      # 10 ms raised-cosine on/off edges

    def g(a: float, b: float) -> np.ndarray:
        y = np.clip(np.minimum((t - a) / ramp, (b - t) / ramp), 0.0, 1.0)
        return (0.5 - 0.5 * np.cos(np.pi * y)).astype(np.float32)

    x = (low * (g(0, 3) + g(6.2, 8.9) + g(9.5, 11.5))
         + high * (g(3.5, 6) + g(9.5, 11.5)))
    return x.astype(np.float32)


def craft_pyannet_freq_params(dims=None, device="cuda"):
    """Deterministic FREQUENCY-SELECTIVE PyanNet weights (tiny dims) →
    (the port's weights on ``device``, dims).

    Random-init pyannet collapses every frame to one powerset class, so a
    random-weight engine run never reaches the overlap path. These values
    make the real pyannet forward behave like the 2-speaker oracle the
    synthetic conversations encode:

      * sinc band 0 is parked on the LOW speaker (200-450 Hz), band 1 on
        the HIGH speaker (1500-2500 Hz) — low_hz/band_hz are physical
        frequencies in ParamSincFB;
      * conv1/conv2 are center-tap channel identities;
      * the LSTM is biased into a pass-through (input and output gates
        saturated open, forget gate closed) so h ≈ tanh(tanh(2x));
      * the classifier maps band-0 energy → powerset class (0,), band-1 →
        class (1,), and their sum → class (0,1), with a silence bias on
        class ().

    Solo-low frames activate speaker 0, solo-high speaker 1, and the
    overlap window both. Requires sinc_filters >= 8 (bands 2+ are parked
    at 6 kHz where the synthetics have no energy). The numbers equal the
    JAX package's crafted weights."""
    from clearconverse_tpu_torch.models.pyannet import (
        PyannetDims, pyannet_from_jax_params)

    dims = dims or PyannetDims(sinc_filters=8, conv_channels=8,
                               lstm_hidden=8, lstm_layers=1,
                               linear_dims=(8,))
    nb = dims.sinc_filters // 2
    C = dims.conv_channels
    H = dims.lstm_hidden
    assert nb >= 2 and C >= 4, "need >=2 sinc bands and >=4 channels"

    # low = 50 + |low_hz|; high = low + 50 + |band_hz|  (pyannet.sinc_filters)
    low_hz = np.full((nb,), 5950.0, np.float32)   # park unused bands at 6 kHz
    band_hz = np.full((nb,), 950.0, np.float32)
    low_hz[0], band_hz[0] = 150.0, 200.0          # band0: 200-450 Hz  (LOW)
    low_hz[1], band_hz[1] = 1450.0, 950.0         # band1: 1500-2500 Hz (HIGH)

    def ident_conv(k, c_in, c_out):
        w = np.zeros((k, c_in, c_out), np.float32)
        for c in range(min(c_in, c_out)):
            w[k // 2, c, c] = 1.0
        return {"w": w, "b": np.zeros((c_out,), np.float32)}

    def norm(c):
        return {"g": np.ones((c,), np.float32), "b": np.zeros((c,), np.float32)}

    # LSTM pass-through: i/o gates saturated open, f closed, g = 2x.
    w_ih = np.zeros((C, 4 * H), np.float32)
    for c in range(min(C, H)):
        w_ih[c, 2 * H + c] = 2.0                  # g-gate block
    b = np.zeros((4 * H,), np.float32)
    b[0:H] = 10.0                                  # i
    b[H:2 * H] = -10.0                             # f
    b[3 * H:4 * H] = 10.0                          # o
    direction = {"w_ih": w_ih, "w_hh": np.zeros((H, 4 * H), np.float32),
                 "b": b}

    lin_w = np.zeros((2 * H, dims.linear_dims[0]), np.float32)
    for c in range(min(H, dims.linear_dims[0])):
        lin_w[c, c] = 0.5                          # fwd half
        lin_w[H + c, c] = 0.5                      # bwd half
    # Powerset order: [(), (0,), (1,), (2,), (0,1), (0,2), (1,2)].
    cls_w = np.zeros((dims.linear_dims[-1], dims.n_classes), np.float32)
    cls_w[0, 1] = cls_w[1, 1] = 4.0               # band0 (cos/sin) → (0,)
    cls_w[2, 2] = cls_w[3, 2] = 4.0               # band1 → (1,)
    cls_w[0:4, 4] = 3.0                           # both → (0,1)
    cls_b = np.zeros((dims.n_classes,), np.float32)
    cls_b[0] = 2.0                                 # silence default: ()

    tree = {
        "sincnet": {
            "wav_norm": norm(1),
            "low_hz": low_hz,
            "band_hz": band_hz,
            "norm0": norm(dims.sinc_filters),
            "conv1": ident_conv(dims.conv_kernel, dims.sinc_filters, C),
            "norm1": norm(C),
            "conv2": ident_conv(dims.conv_kernel, C, C),
            "norm2": norm(C),
        },
        "lstm": [{"fwd": dict(direction), "bwd": dict(direction)}],
        "linear": [{"w": lin_w,
                    "b": np.zeros((dims.linear_dims[0],), np.float32)}],
        "classifier": {"w": cls_w, "b": cls_b},
    }
    return pyannet_from_jax_params(tree, dims, device), dims
