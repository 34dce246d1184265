"""Lossless bit-packed delta wire for host→device audio uploads.

``load_audio_many``'s lossless wire takes this form to any device but a
CUDA one: it is the JAX package's wire, built for a host link slow enough
that the host time spent packing paid for the bytes it saved, and the CPU
tests hold the port to it. To a CUDA device the same batch goes as raw
int16 from page-locked memory, where the quarter of the bytes it would
save crosses PCIe faster than the host packs it; the gate's input is the
same either way.

Speech waveforms at 16 kHz / 16 bit are heavily oversampled, so their
sample-to-sample deltas need far fewer bits than the samples: first- or
second-order deltas of speech fit 9–12 bits. The packing is exactly
invertible, so the device rebuilds the int16 batch bit for bit and every
result equals the raw int16 wire's.

Format (per upload), as the JAX package's audio/pack.py defines it:
  * order ``k`` in {1, 2}: the stream carries k-th order deltas, whichever
    order needs the narrower width;
  * width ``W`` in [4, 15]: each delta is stored unsigned as delta +
    2^(W-1), W rounded up to ``WIDTH_BUCKETS``; above ``AUTO_MAX_WIDTH``
    the caller sends raw int16 instead;
  * groups of 8 samples pack into exactly W bytes, little-endian, so the
    byte stream is [K, T*W/8] uint8 with static per-sample offsets (T a
    multiple of 8);
  * side channel: per-row ``x0`` (sample 0) and ``e1`` (the slot-1 delta,
    up to 17 bits); slots 0 and 1 of the stream pack as zeros;
  * rows shorter than T get a short linear taper into the padding (don't-
    care values the device masks away) so the valid→pad step never sets W.

The host packs with the native library (audio/native); the device unpacks
with int32 tensor ops (``unpack_delta``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MIN_WIDTH = 4
MAX_WIDTH = 15
# Widths 14–15 save little over raw int16 and only near-full-scale wideband
# noise needs them; such batches take the raw int16 wire.
AUTO_MAX_WIDTH = 13
# Measured widths round up to this set (≤1 extra bit).
WIDTH_BUCKETS = (8, 10, 12, 13)
_TAPER = 256          # max taper samples from a row's last value to zero


@dataclasses.dataclass(frozen=True)
class PackedBatch:
    """One packed upload: ``data`` [K, T*width//8] uint8, side arrays
    ``x0``/``e1`` [K] int32, the delta ``order`` (1 or 2), the ``width`` in
    bits, and the unpacked length ``t``."""

    data: np.ndarray
    x0: np.ndarray
    e1: np.ndarray
    order: int
    width: int
    t: int


def _taper_padding(q: np.ndarray, n_valid) -> np.ndarray:
    """Replace each row's zero padding with a linear ramp from the last
    valid sample at slope |last|/_TAPER (stopping short of zero when the pad
    is shorter than _TAPER). Returns a copy only if needed."""
    K, T = q.shape
    out = None
    for r in range(K):
        n = int(n_valid[r])
        if n <= 0 or n >= T:
            continue
        last = int(q[r, n - 1])
        if last == 0:
            continue
        if out is None:
            out = q.copy()
        L = min(T - n, _TAPER)
        ramp = np.round(last * (1.0 - np.arange(1, L + 1) / _TAPER))
        out[r, n: n + L] = ramp.astype(np.int16)
    return q if out is None else out


def _signed_width(max_abs: int) -> int:
    """Smallest signed two's-complement width holding ±max_abs."""
    return max(int(max_abs).bit_length() + 1, MIN_WIDTH)


def pack_bits_np(u: np.ndarray, width: int) -> np.ndarray:
    """[K, T] unsigned values < 2**width → [K, T*width//8] uint8: groups of
    8 samples concatenate little-endian into exactly ``width`` bytes."""
    K, T = u.shape
    if T % 8:
        raise ValueError(f"T must be a multiple of 8, got {T}")
    g = u.reshape(K, T // 8, 8).astype(np.uint64)
    lo = np.zeros((K, T // 8), np.uint64)
    hi = np.zeros((K, T // 8), np.uint64)
    for i in range(8):
        s = i * width
        if s < 64:
            lo |= g[:, :, i] << np.uint64(s)
            if s + width > 64:
                hi |= g[:, :, i] >> np.uint64(64 - s)
        else:
            hi |= g[:, :, i] << np.uint64(s - 64)
    both = np.concatenate(
        [lo[..., None].view(np.uint8).reshape(K, T // 8, 8),
         hi[..., None].view(np.uint8).reshape(K, T // 8, 8)], axis=-1)
    return np.ascontiguousarray(both[:, :, :width]).reshape(K, T * width // 8)


def unpack_bits_np(data: np.ndarray, width: int) -> np.ndarray:
    """Host mirror of the device unpack: [K, T*width//8] uint8 → [K, T]
    unsigned int32 values < 2**width."""
    K, nbytes = data.shape
    T = nbytes * 8 // width
    gb = data.reshape(K, T // 8, width).astype(np.uint32)
    gb = np.concatenate([gb, np.zeros((K, T // 8, 2), np.uint32)], axis=-1)
    mask = np.uint32((1 << width) - 1)
    cols = []
    for i in range(8):
        bit = i * width
        j, s = bit >> 3, bit & 7
        v = (gb[:, :, j] | (gb[:, :, j + 1] << np.uint32(8))
             | (gb[:, :, j + 2] << np.uint32(16))) >> np.uint32(s)
        cols.append((v & mask).astype(np.int32))
    return np.stack(cols, axis=-1).reshape(K, T)


def unpack_delta(data: torch.Tensor, x0: torch.Tensor, e1: torch.Tensor,
                 order2: bool, width: int) -> torch.Tensor:
    """Device decode: packed bytes [K, T*width//8] uint8 + side arrays →
    int32 waveform [K, T], bit-identical to the packed input. Every index is
    a static slice; the cumulative sums are exact in integers."""
    K, nbytes = data.shape
    T = nbytes * 8 // width
    gb = torch.cat([data.reshape(K, T // 8, width).to(torch.int32),
                    torch.zeros((K, T // 8, 2), dtype=torch.int32,
                                device=data.device)], dim=-1)
    mask = (1 << width) - 1
    cols = []
    for i in range(8):
        bit = i * width
        j, s = bit >> 3, bit & 7
        v = (gb[:, :, j] | (gb[:, :, j + 1] << 8) | (gb[:, :, j + 2] << 16)) >> s
        cols.append(v & mask)
    p = torch.stack(cols, dim=-1).reshape(K, T) - (1 << (width - 1))
    # Slot 1 carries e1 (17 bits worst case, outside the packed width).
    p = torch.cat([p[:, :1], e1[:, None].to(torch.int32), p[:, 2:]], dim=1)
    c = torch.cumsum(p, dim=1, dtype=torch.int32)     # order-1 reconstruction
    if order2:
        c = torch.cumsum(c, dim=1, dtype=torch.int32)
    return x0[:, None].to(torch.int32) + c


def pack_i16_batch(q: np.ndarray, n_valid,
                   max_width: int = AUTO_MAX_WIDTH,
                   allow_numpy: bool = False) -> "PackedBatch | None":
    """Pack an int16 batch [K, T] (zero-padded past ``n_valid``) for the
    wire, or None when no delta order fits within ``max_width`` bits (the
    caller then sends raw int16).

    Both passes (max-|delta| scan, delta + bit-pack) run in the native
    library; without it this returns None, unless ``allow_numpy`` asks for
    the numpy mirror (the tests' oracle)."""
    from clearconverse_tpu_torch.audio import native

    K, T = q.shape
    if T % 8 or T < 2:
        return None
    if native.get_lib() is None and not allow_numpy:
        return None
    q = _taper_padding(q, n_valid)
    scanned = native.delta_scan(q)
    if scanned is None:                                # numpy test oracle
        x32 = q.astype(np.int32)
        d1 = np.diff(x32, axis=1)
        scanned = ((int(np.max(np.abs(d1[:, 1:]))) if T > 2 else 0),
                   (int(np.max(np.abs(np.diff(d1, axis=1)))) if T > 2 else 0))
    m1, m2 = scanned
    w1, w2 = _signed_width(m1), _signed_width(m2)
    order, width = (1, w1) if w1 <= w2 else (2, w2)
    width = next((b for b in WIDTH_BUCKETS if b >= width), width)
    if width > min(max_width, MAX_WIDTH):
        return None
    packed = native.delta_pack(q, order, width)
    if packed is not None:
        data, x0, e1 = packed
        return PackedBatch(data=data, x0=x0, e1=e1, order=order,
                           width=width, t=T)
    x = q.astype(np.int32)
    d1 = np.diff(x, axis=1)                           # [K, T-1]
    p = np.zeros((K, T), np.int32)
    p[:, 2:] = d1[:, 1:] if order == 1 else np.diff(d1, axis=1)
    data = pack_bits_np((p + (1 << (width - 1))).astype(np.uint16), width)
    return PackedBatch(data=data, x0=x[:, 0].copy(), e1=d1[:, 0].copy(),
                       order=order, width=width, t=T)
