"""RIFF/WAVE codec, numpy path.

PCM 8/16/24/32-bit and IEEE float 32/64, any channel count, tolerant of the
extension chunks real encoders emit. ``read_wav_i16`` is the raw path for
mono 16-bit PCM; ``scan_layout`` finds where such a file's samples lie, so
``audio/decode.load_audio_many`` can read them straight into its batch.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


def scan_layout(fh, path: str):
    """RIFF chunk walk over an open file's headers alone → ((tag, channels,
    rate, bits), payload offset, payload bytes). Extension chunks are
    skipped, odd-sized chunks are word-aligned, and a data chunk that runs
    past the end of the file is cut at it; the payload is not read."""
    end = os.fstat(fh.fileno()).st_size
    head = fh.read(12)
    if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    fmt = None
    data = None
    pos = 12
    while pos + 8 <= end:
        fh.seek(pos)
        hdr = fh.read(8)
        cid = hdr[:4]
        (size,) = struct.unpack_from("<I", hdr, 4)
        body = min(size, end - pos - 8)
        if cid == b"fmt ":
            fmt = _parse_fmt(fh.read(body))
        elif cid == b"data":
            data = (pos + 8, body)
        pos += 8 + size + (size & 1)  # chunks are word-aligned
        if fmt is not None and data is not None:
            break
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    return fmt, data[0], data[1]


def _scan_chunks(path: str):
    """RIFF chunk walk → ((tag, channels, rate, bits), data payload)."""
    with open(path, "rb") as fh:
        fmt, offset, nbytes = scan_layout(fh, path)
        fh.seek(offset)
        return fmt, fh.read(nbytes)


def read_wav_i16(path: str):
    """Mono 16-bit PCM → (int16 [T] samples, rate), or None for any other
    layout: the native grid goes to the device without a float round trip."""
    fmt, payload = _scan_chunks(path)
    if not is_mono_i16(fmt):
        return None
    return np.frombuffer(payload, dtype="<i2"), fmt[2]


def is_mono_i16(fmt) -> bool:
    """True for the layout ``read_wav_i16`` takes: mono 16-bit PCM."""
    tag, channels, _, bits = fmt
    return tag == _PCM and bits == 16 and channels == 1


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file → (float32 samples in [-1, 1] of shape [channels, T],
    sample_rate). Channel-major, as torchaudio.load returns it."""
    (tag, channels, rate, bits), payload = _scan_chunks(path)
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
