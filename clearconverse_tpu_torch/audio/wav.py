"""RIFF/WAVE codec, numpy path.

PCM 8/16/24/32-bit and IEEE float 32/64, any channel count, tolerant of the
extension chunks real encoders emit. ``read_wav_i16`` is the raw fast path
for mono 16-bit PCM that ``audio/decode.load_audio_many`` sends to the device
as int16.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


def _scan_chunks(path: str):
    """RIFF chunk walk → ((tag, channels, rate, bits), data payload)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    fmt = None
    payload = None
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = _parse_fmt(body)
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
        if fmt is not None and payload is not None:
            break
    if fmt is None or payload is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    return fmt, payload


def read_wav_i16(path: str, scanned=None):
    """Mono 16-bit PCM → (int16 [T] samples, rate), or None for any other
    layout: the native grid goes to the device without a float round trip.
    ``scanned`` (a prior ``_scan_chunks`` result) skips re-reading the file
    when the caller probes this path before falling back to read_wav."""
    fmt, payload = scanned if scanned is not None else _scan_chunks(path)
    tag, channels, rate, bits = fmt
    if tag != _PCM or bits != 16 or channels != 1:
        return None
    return np.frombuffer(payload, dtype="<i2"), rate


def read_wav(path: str, scanned=None) -> Tuple[np.ndarray, int]:
    """Read a WAV file → (float32 samples in [-1, 1] of shape [channels, T],
    sample_rate). Channel-major, as torchaudio.load returns it. ``scanned``
    reuses a prior ``_scan_chunks`` result (see read_wav_i16)."""
    (tag, channels, rate, bits), payload = (
        scanned if scanned is not None else _scan_chunks(path))
    samples = _decode_pcm(payload, tag, bits)
    if channels > 1:
        usable = (samples.shape[0] // channels) * channels
        samples = samples[:usable].reshape(-1, channels).T
    else:
        samples = samples[None, :]
    return np.ascontiguousarray(samples), rate


def _parse_fmt(body: bytes):
    tag, channels, rate = struct.unpack_from("<HHI", body, 0)
    bits = struct.unpack_from("<H", body, 14)[0]
    if tag == _EXTENSIBLE and len(body) >= 26:
        # True format lives in the extension's SubFormat GUID (first 2 bytes).
        tag = struct.unpack_from("<H", body, 24)[0]
    return tag, channels, rate, bits


def _decode_pcm(payload: bytes, tag: int, bits: int) -> np.ndarray:
    if tag == _IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        return np.frombuffer(payload, dtype=dtype).astype(np.float32)
    if tag != _PCM:
        raise ValueError(f"unsupported WAV format tag {tag}")
    if bits == 16:
        return np.frombuffer(payload, dtype="<i2").astype(np.float32) / 32768.0
    if bits == 32:
        return np.frombuffer(payload, dtype="<i4").astype(np.float32) / 2147483648.0
    if bits == 8:  # unsigned
        return (np.frombuffer(payload, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    if bits == 24:
        raw = np.frombuffer(payload, dtype=np.uint8)
        raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
        val = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        val = np.where(val & 0x800000, val - 0x1000000, val)
        return val.astype(np.float32) / 8388608.0
    raise ValueError(f"unsupported PCM bit depth {bits}")


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write float samples ([C, T] or [T]) as 16-bit PCM WAV (pcm_s16le)."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[None, :]
    channels, _ = samples.shape
    interleaved = samples.T.reshape(-1)
    pcm = np.clip(np.round(interleaved * 32767.0), -32768, 32767).astype("<i2")
    body = pcm.tobytes()

    hdr = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, _PCM, channels, sample_rate,
        sample_rate * channels * 2, channels * 2, 16,
    )
    hdr += b"data" + struct.pack("<I", len(body))
    with open(path, "wb") as fh:
        fh.write(hdr + body)
