"""Kernel K1: fused Whisper mel power (csrc/logmel.cu).

Port of the JAX package's Pallas TPU kernel ``mel_power_pallas``
(clearconverse_tpu/ops/pallas/logmel.py). ``mel_power`` launches the CUDA
kernel for a CUDA tensor and runs ``mel_power_plain`` for a CPU tensor; it
never falls back from one to the other. ``mel_power.launches`` counts the
kernel launches.

The kernel runs both products (DFT and mel projection) as 3xTF32 ``wgmma``
on the tensor cores. ``kernel_operands`` lays out its B operands on the
host: the windowed DFT folded about the frame's centre (``folded_dft``) and
the filterbank, split into exact TF32 hi/lo halves, cut into the stages its
TMA ring copies, in the 32-byte swizzle its ``wgmma`` descriptors name.
``tile_shape`` mirrors the kernel's ``Shape``; the kernel refuses an
operand buffer whose size differs from its own count of stage bytes.
``folded=False`` lays out the unfolded 400-sample DFT, for the timing
variant of ``ops/kernel_variants.py`` that does without the fold.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from clearconverse_tpu_torch.audio import mel as melmod
from clearconverse_tpu_torch.ops import build

HOP = melmod.HOP_LENGTH
N_FFT = melmod.N_FFT
N_FREQ = N_FFT // 2 + 1
# The DFT's K after folding each frame about its centre: x[n] +- x[400 - n]
# for n < 208, 26 k8-steps (n = 201..207 carry zero weight).
N_FOLD = 208
DFT_PER = 2                         # k8-steps of samples a DFT stage
# The filterbank's rows within each group of 8 bins, in the k-slot order of
# a TF32 A fragment: slot t holds bin 2t, slot t + 4 bin 2t + 1.
FB_PERM = np.array([0, 2, 4, 6, 1, 3, 5, 7])


@dataclass(frozen=True)
class TileShape:
    """csrc/logmel.cu's ``Shape<mel_n>``: the DFT's K (``n_k`` samples,
    N_FOLD folded), bins a chunk (``nc``), chunks, DFT stages a chunk, the
    bytes a DFT stage fills, the k8-steps of bins a filterbank stage holds
    and the bytes it fills, the bytes a ring slot takes, filterbank stages a
    chunk, and the stages a CTA takes (per chunk: the DFT stages, then the
    filterbank stages)."""
    mel_n: int
    n_k: int
    nc: int
    chunks: int
    dft_stages: int
    dft_bytes: int
    fb_per: int
    fb_bytes: int
    stage_bytes: int
    fb_stages: int
    stages: int


def tile_shape(n_mels: int, folded: bool = True) -> TileShape:
    mel_n = 80 if n_mels <= 80 else 128
    n_k = N_FOLD if folded else N_FFT
    nc = 72 if mel_n == 80 else 48
    chunks = -(-N_FREQ // nc)
    dft_stages = n_k // 8 // DFT_PER
    dft_bytes, fb_step = DFT_PER * 4 * nc * 32, 2 * mel_n * 32
    fb_per = max(1, dft_bytes // fb_step)
    fb_stages = -(-(nc // 8) // fb_per)
    return TileShape(mel_n, n_k, nc, chunks, dft_stages, dft_bytes, fb_per,
                     fb_per * fb_step, max(dft_bytes, fb_per * fb_step),
                     fb_stages, chunks * (dft_stages + fb_stages))


def tf32_round(x: np.ndarray) -> np.ndarray:
    """f32 → TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32`` rounds: to
    nearest, ties away from zero; the low 13 bits come out zero."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(x: np.ndarray):
    """x → (hi, lo), both exactly TF32, hi + lo = x to about 2^-22."""
    x = np.asarray(x, dtype=np.float32)
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def sw32(tile: np.ndarray) -> np.ndarray:
    """A K-major [rows, 8] f32 tile (rows a multiple of 8) as its shared-
    memory image under the 32-byte swizzle: row r at byte 32r, its two
    16-byte halves swapped where bit 2 of r is set (address bit 4 ^= bit 7).
    The swizzle is its own inverse."""
    t = np.ascontiguousarray(tile, dtype=np.float32).reshape(-1, 2, 4)
    swap = ((np.arange(t.shape[0]) >> 2) & 1).astype(bool)
    t = np.where(swap[:, None, None], t[:, ::-1], t)
    return t.reshape(-1)


def folded_dft() -> tuple:
    """The windowed DFT folded about the frame's centre, f32 [N_FOLD, 201]
    each. The periodic Hann window and the basis are symmetric about sample
    200 (w[0] = 0), so re = sum_n (x[n] + x[400-n]) cos_f[n] and im = sum_n
    (x[n] - x[400-n]) sin_f[n] over n < N_FOLD: cos_f is the windowed
    cosine for n <= 200 with row 200 halved (the fold counts x[200] twice),
    sin_f the windowed sine for n < 200; every other row is zero."""
    cos_m, sin_m = melmod._dft_matrices()            # [400, 201]
    cos_f = np.zeros((N_FOLD, N_FREQ), np.float32)
    sin_f = np.zeros((N_FOLD, N_FREQ), np.float32)
    cos_f[1:200], sin_f[1:200] = cos_m[1:200], sin_m[1:200]
    cos_f[200] = 0.5 * cos_m[200]
    return cos_f, sin_f


@functools.lru_cache(maxsize=4)
def kernel_operands(n_mels: int = 80, folded: bool = True) -> np.ndarray:
    """The kernel's B operands, f32, one ring slot (``stage_bytes``) per
    stage in the order a CTA takes them. For each chunk of ``nc`` bins:
    ``dft_stages`` DFT stages (for each of DFT_PER k8-steps: cos hi, cos lo,
    sin hi, sin lo of ``folded_dft``, or of the unfolded windowed DFT, as
    [nc bins, 8 samples] tiles), then the filterbank stages (``fb_per``
    k8-steps of the chunk's bins, each a hi and a lo [mel_n mels, 8 bins in
    FB_PERM order] tile, zero-padded). Bins past 200 and mels past
    ``n_mels`` are zero."""
    sh = tile_shape(n_mels, folded)
    n_bins = sh.chunks * sh.nc
    dft = np.zeros((2, n_bins, sh.n_k), np.float32)
    dft[0, :N_FREQ], dft[1, :N_FREQ] = (
        m.T for m in (folded_dft() if folded else melmod._dft_matrices()))
    dft_hi, dft_lo = split_tf32(dft)
    fb = np.zeros((n_bins, sh.mel_n), np.float32)
    fb[:N_FREQ, :n_mels] = melmod.mel_filterbank(n_mels=n_mels)
    fb_hi, fb_lo = split_tf32(fb)
    out = np.zeros((sh.stages, sh.stage_bytes // 4), np.float32)
    k = 0
    for j in range(sh.chunks):
        bins = slice(j * sh.nc, (j + 1) * sh.nc)
        for s in range(sh.dft_stages):
            out[k, :sh.dft_bytes // 4] = np.concatenate([
                sw32(m[bins, 8 * q:8 * q + 8])
                for q in range(DFT_PER * s, DFT_PER * (s + 1))
                for m in (dft_hi[0], dft_lo[0], dft_hi[1], dft_lo[1])])
            k += 1
        for fs in range(sh.fb_stages):
            steps = range(fs * sh.fb_per, min((fs + 1) * sh.fb_per, sh.nc // 8))
            flat = np.concatenate([
                sw32(m[j * sh.nc + 8 * i + FB_PERM].T)
                for i in steps for m in (fb_hi, fb_lo)])
            out[k, :flat.size] = flat
            k += 1
    return out.reshape(-1)


@functools.lru_cache(maxsize=8)
def device_operands(device: torch.device, n_mels: int = 80,
                    folded: bool = True) -> torch.Tensor:
    """``kernel_operands(n_mels, folded)`` on ``device``, uploaded once."""
    return torch.from_numpy(kernel_operands(n_mels, folded)).to(device)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("logmel")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cc_mel_power.argtypes = [p, i, i, p, ctypes.c_longlong, i, p, p]
    lib.cc_mel_power.restype = i
    return lib


def mel_power_plain(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """K1's plain version: reflect pad, frame, DFT matmuls, power and mel,
    all in f32. [B, T] → [B, T//160, n_mels]."""
    return melmod.mel_power(audio, n_mels)


def mel_power(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """[B, T] f32 audio (T a multiple of 160) → [B, T//160, n_mels] mel
    power. CPU tensor: the plain version. CUDA tensor: the kernel."""
    if audio.device.type == "cpu":
        return mel_power_plain(audio, n_mels)
    if audio.device.type != "cuda":
        raise ValueError(f"mel_power: unsupported device {audio.device}")
    if audio.dtype != torch.float32 or audio.ndim != 2:
        raise ValueError(f"mel_power: want [B, T] float32, got "
                         f"{tuple(audio.shape)} {audio.dtype}")
    B, T = audio.shape
    if T % HOP or T <= N_FFT // 2:
        raise ValueError(f"mel_power: T={T} must be a multiple of {HOP} "
                         f"above {N_FFT // 2}")
    if not 1 <= n_mels <= 128:
        raise ValueError(f"mel_power: n_mels={n_mels} outside 1..128")
    audio = audio.contiguous()
    if audio.data_ptr() % 16:
        raise ValueError("mel_power: audio must start 16-byte aligned")
    ops = device_operands(audio.device, n_mels)
    out = torch.empty((B, T // HOP, n_mels), dtype=torch.float32,
                      device=audio.device)
    rc = _lib().cc_mel_power(
        audio.data_ptr(), B, T, ops.data_ptr(), ops.numel() * 4, n_mels,
        out.data_ptr(), torch.cuda.current_stream(audio.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cc_mel_power launch failed: CUDA error {rc}")
    mel_power.launches += 1
    return out


mel_power.launches = 0
