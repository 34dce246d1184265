"""Container decode and canonical loading.

``ensure_wav_format`` (back/api.py:530-568) and ``load_audio``
(back/api.py:799-838): WAV decodes in audio/wav.py; other containers go
through an ffmpeg subprocess when the binary exists, keeping the original
path on failure. ``load_audio_many`` is the engine's batched load: per-file
host decode, one upload over the audio wire (lossless delta packing by
default), one gate + normalize over the padded batch on the device, and a
download of the gated batch that starts only when a caller first reads the
bytes (``LazyAudio``).
"""

from __future__ import annotations

import logging
import math
import shutil
import subprocess
import threading
import time
from typing import Tuple

import numpy as np
import torch

from clearconverse_tpu_torch.audio import denoise as _denoise
from clearconverse_tpu_torch.audio.resample import resample
from clearconverse_tpu_torch.audio.wav import _scan_chunks, read_wav, read_wav_i16
from clearconverse_tpu_torch.utils.errors import is_fatal
from clearconverse_tpu_torch.utils.tracing import force_sync

logger = logging.getLogger(__name__)

TARGET_SR = 16000


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def ensure_wav_format(file_path: str) -> str:
    """Convert non-WAV audio to 16 kHz mono pcm_s16le WAV via ffmpeg
    (reference back/api.py:544-556 flags), written beside the input as
    ``<name>.wav`` (the full name, so "talk.mp3" and "talk.m4a" never
    collide). Returns the original path when the input is already WAV or
    conversion is impossible."""
    if file_path.lower().endswith(".wav"):
        return file_path
    if not ffmpeg_available():
        logger.warning("ffmpeg unavailable; keeping %s as-is", file_path)
        return file_path
    wav_path = file_path + ".wav"
    cmd = ["ffmpeg", "-y", "-i", file_path,
           "-acodec", "pcm_s16le", "-ar", str(TARGET_SR), "-ac", "1", wav_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        return wav_path
    except (subprocess.CalledProcessError, OSError) as exc:
        logger.error("ffmpeg conversion failed for %s: %s", file_path, exc)
        return file_path


# Length ladder (seconds): uploads pad to the next bucket (zeros are masked
# out of the gate's statistics) so the batch takes one of a few shapes.
_LEN_BUCKETS_S = (1, 2, 5, 10, 30, 60, 120, 300, 600, 1500)


def _next_bucket(n: int, sr: int) -> int:
    for s in _LEN_BUCKETS_S:
        if n <= s * sr:
            return s * sr
    return -(-n // (300 * sr)) * (300 * sr)  # beyond ladder: 5-min multiples


def load_audio(file_path: str, target_sr: int = TARGET_SR,
               noise_reduction_amount: float = 0.5,
               denoise: bool = True, device="cuda") -> Tuple[torch.Tensor, int]:
    """WAV/convertible file → (float32 [T] waveform at target_sr on
    ``device``, sr): stereo→mono mean, resample, stationary spectral-gate
    denoise, peak-normalize (+1e-8), as back/api.py:799-838 does. Lengths
    bucket as in load_audio_many; the gate masks the padding."""
    file_path = ensure_wav_format(file_path)
    samples, sr = read_wav(file_path)              # [C, T]
    mono = samples.mean(axis=0)
    n_in = len(mono)
    wave = torch.from_numpy(np.pad(mono, (0, _next_bucket(n_in, sr) - n_in))
                            .astype(np.float32)).to(device)
    n_out = n_in
    if sr != target_sr:
        wave = resample(wave, sr, target_sr)
        n_out = int(math.ceil(target_sr * n_in / sr))
    if denoise and noise_reduction_amount > 0:
        wave = _denoise.spectral_gate_normalized(
            wave[None], noise_reduction_amount,
            torch.tensor([n_out], device=wave.device), sr=target_sr)[0]
    else:
        wave = _denoise.peak_normalize(wave)   # pad is zeros: peak equal
    return wave[:n_out], target_sr


class _Lazy1D:
    """Shared facade for lazily materialized float32 [T] audio: the length is
    known at once, the bytes appear on first access (``_materialize``).
    Covers the engine's access patterns (len, slicing, np.asarray); results
    leave the pipeline as real arrays (engine ``_finalize``)."""

    _n: int

    def _materialize(self) -> np.ndarray:
        raise NotImplementedError

    def __len__(self) -> int:
        return self._n

    @property
    def size(self) -> int:
        return self._n

    @property
    def shape(self):
        return (self._n,)

    @property
    def ndim(self) -> int:
        return 1

    @property
    def dtype(self):
        return np.dtype(np.float32)

    def __getitem__(self, key):
        return self._materialize()[key]

    def __array__(self, dtype=None, copy=None):
        a = self._materialize()
        if dtype is not None and np.dtype(dtype) != a.dtype:
            return a.astype(dtype)
        return np.array(a) if copy else a


class LazyAudio(_Lazy1D):
    """Float32 [T] file audio whose bytes have not left the device yet
    (``load_audio_many(host_async=True)``). The shared download thread starts
    on the first byte access, or on ``prefetch()`` from a caller that knows
    the bytes will be needed; a run whose consumers all read the device
    AudioStore never downloads. ``stats_flush`` folds the thread's span into
    the caller's stage dict once it has finished (main thread only)."""

    def __init__(self, join, row: int, n: int, flush=None,
                 start=None, started=None):
        self._join = join
        self._row = row
        self._n = n
        self._arr = None
        self.stats_flush = flush
        self._start = start
        self._started = started

    def _materialize(self) -> np.ndarray:
        if self._arr is None:
            # A copy, not a view: a view would pin the whole batch and let
            # one segment's mutation reach its siblings.
            self._arr = self._join()[self._row, : self._n].copy()
        return self._arr

    def prefetch(self) -> None:
        """Start the download thread without blocking."""
        if self._arr is None and self._start is not None:
            self._start()

    def wait(self) -> None:
        """Drain an in-flight download thread (a download that never started
        stays unstarted). A transfer error stays deferred to the first byte
        access, where per-file isolation turns it into a None result."""
        if self._started is not None and not self._started():
            return
        try:
            self._join()
        except Exception:  # noqa: BLE001 — surfaced at first byte access
            pass


class LazyClip(_Lazy1D):
    """Lazy float32 [T] sub-view of an audio source (LazyAudio or ndarray):
    bounds clamp at once, bytes materialize on first access."""

    def __init__(self, src, a: int, b: int):
        n = len(src)
        self._src = src
        self._a = min(max(int(a), 0), n)
        self._b = min(max(int(b), self._a), n)
        self._n = self._b - self._a
        self._arr = None

    def _materialize(self) -> np.ndarray:
        if self._arr is None:
            self._arr = np.asarray(self._src[self._a: self._b], np.float32)
        return self._arr


def lazy_slice(audio, a: int, b: int):
    """audio[a:b] without reading bytes when ``audio`` is lazy; plain
    ndarrays slice eagerly."""
    if isinstance(audio, np.ndarray):
        return np.asarray(audio[a:b], np.float32)
    return LazyClip(audio, a, b)


def load_audio_many(paths, target_sr: int = TARGET_SR,
                    noise_reduction_amount: float = 0.5,
                    denoise: bool = True, return_device: bool = False,
                    stage_times=None, host_async: bool = False,
                    wire_bits: int = 16, wire_info=None, device="cuda"):
    """Batched multi-file load: per-file host decode (and resample of files
    not at ``target_sr``), then one upload and one gate + normalize over the
    padded batch on ``device``, and one download.

    Returns a list aligned with ``paths``: float32 [T] arrays (LazyAudio
    views with ``host_async`` and ``return_device``), or None for files that
    failed to load. With ``return_device=True`` also returns the gated
    device batch [K, T] and a path → row map (the engine's AudioStore).

    ``wire_bits``: 0 = lossless delta packing (raw int16 when no order fits
    13 bits or the native packer is missing), 16 = raw int16, 8 = mu-law.
    ``wire_info`` (a dict) receives what crossed the wire: format, width,
    bytes. ``stage_times`` (a dict) receives host_decode, upload_gate and
    download spans."""
    def _mark(key: str, t0: float) -> float:
        t1 = time.perf_counter()
        if stage_times is not None:
            stage_times[key] = stage_times.get(key, 0.0) + (t1 - t0)
        return t1

    if wire_bits not in (0, 8, 16):
        raise ValueError(f"wire_bits must be 0 (lossless packed), 8, or "
                         f"16, got {wire_bits}")
    device = torch.device(device)
    t0 = time.perf_counter()
    waves, n_outs, order = [], [], []
    results = [None] * len(paths)
    row_map = [None] * len(paths)

    for i, p in enumerate(paths):
        try:
            p = ensure_wav_format(p)
            # Mono 16-bit PCM at target_sr keeps its int16 grid all the way
            # to the device: no float round trip, no requantization.
            scanned = _scan_chunks(p)
            fast = read_wav_i16(p, scanned=scanned)
            if fast is not None and fast[1] == target_sr:
                waves.append(fast[0])
                n_outs.append(len(fast[0]))
                order.append(i)
                continue
            samples, sr = read_wav(p, scanned=scanned)
            mono = samples.mean(axis=0).astype(np.float32)
            n_out = len(mono)
            if sr != target_sr:
                padded = np.pad(mono, (0, _next_bucket(n_out, sr) - n_out))
                n_out = int(math.ceil(target_sr * n_out / sr))
                mono = resample(torch.from_numpy(padded).to(device), sr,
                                target_sr)[:n_out].cpu().numpy()
            waves.append(mono)
            n_outs.append(n_out)
            order.append(i)
        except Exception as exc:  # noqa: BLE001 — per-file failure → None
            if is_fatal(exc):
                raise
            logger.error("load_audio failed for %s: %s", p, exc)
    if not waves:
        return (results, None, row_map) if return_device else results
    # The batch assembles on the host and crosses the wire as int16 (or
    # mu-law): native int16 rows keep their grid; float rows pre-scale to
    # their own peak first (the gate is scale-invariant and the output is
    # peak-normalized, so quiet sources keep 16-bit precision).
    T = _next_bucket(max(n_outs), target_sr)
    if wire_bits == 8:
        from clearconverse_tpu_torch.audio.wire import (mulaw_encode_i16_np,
                                                        mulaw_encode_np)
        q_up = np.full((len(waves), T), 128, np.uint8)  # code 128 = 0.0
        for row, w in enumerate(waves):
            if w.dtype == np.int16:
                q_up[row, : len(w)] = mulaw_encode_i16_np(w)
                continue
            x = np.asarray(w, np.float32)
            peak = max(float(np.max(np.abs(x))), 1e-12) if len(x) else 1e-12
            q_up[row, : len(x)] = mulaw_encode_np(x / peak)
    else:
        q_up = np.zeros((len(waves), T), np.int16)
        for row, w in enumerate(waves):
            if w.dtype == np.int16:
                q_up[row, : len(w)] = w
                continue
            peak = max(float(np.max(np.abs(w))), 1e-12) if len(w) else 1e-12
            scaled = w * (32767.0 / peak)
            q_up[row, : len(w)] = np.clip(np.round(scaled), -32768,
                                          32767).astype(np.int16)
    packed = None
    if wire_bits == 0:
        from clearconverse_tpu_torch.audio.pack import pack_i16_batch
        packed = pack_i16_batch(q_up, n_outs)
    if wire_info is not None:
        wire_info["bytes_raw_int16"] = int(q_up.size) * 2
        if packed is not None:
            wire_info.update(format="packed_delta", width=packed.width,
                             order=packed.order,
                             bytes_wire=int(packed.data.size
                                            + packed.x0.size * 8))
        elif wire_bits == 8:
            wire_info.update(format="mulaw8", width=8,
                             bytes_wire=int(q_up.size))
        else:
            wire_info.update(format="int16", width=16,
                             bytes_wire=int(q_up.size) * 2)
    t0 = _mark("host_decode", t0)
    dn = bool(denoise and noise_reduction_amount > 0)
    n_valid = torch.tensor(n_outs, dtype=torch.int32, device=device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if packed is not None:
        batch, q_down = _denoise.gate_normalize_packed(
            put(packed.data), put(packed.x0), put(packed.e1),
            packed.order == 2, noise_reduction_amount, n_valid,
            sr=target_sr, denoise=dn, width=packed.width)
    else:
        gate = (_denoise.gate_normalize_u8 if wire_bits == 8
                else _denoise.gate_normalize_i16)
        batch, q_down = gate(put(q_up), noise_reduction_amount, n_valid,
                             sr=target_sr, denoise=dn)
    force_sync()
    t0 = _mark("upload_gate", t0)
    if wire_bits == 8:
        from clearconverse_tpu_torch.audio.wire import mulaw_decode_np

        def to_host(q):
            return mulaw_decode_np(q.cpu().numpy())
    else:
        def to_host(q):
            return q.cpu().numpy().astype(np.float32) / 32767.0
    if host_async and return_device:
        # LazyAudio views over a download thread that starts at the first
        # byte access (or prefetch): the device-side phases all read the
        # AudioStore, so a clean run never downloads.
        holder = {}

        def _download():
            # The thread writes only its own holder keys, never stage_times
            # (the main thread iterates that dict).
            td = time.perf_counter()
            try:
                holder["host"] = to_host(q_down)
            except Exception as exc:  # noqa: BLE001 — surfaced at join time
                holder["error"] = exc
            holder["elapsed"] = time.perf_counter() - td

        th = threading.Thread(target=_download, daemon=True)
        start_lock = threading.Lock()

        def _start():
            with start_lock:
                if not holder.get("started"):
                    holder["started"] = True
                    th.start()

        def _flush_stats():
            """Fold the thread's span into stage_times: main thread only,
            once the thread has finished."""
            if (stage_times is None or th.is_alive()
                    or holder.get("folded") or "elapsed" not in holder):
                return
            holder["folded"] = True
            stage_times["download_async"] = (
                stage_times.get("download_async", 0.0) + holder["elapsed"])

        def _join():
            _start()
            tw = time.perf_counter()
            th.join()
            if stage_times is not None:
                stage_times["download_wait"] = (
                    stage_times.get("download_wait", 0.0)
                    + (time.perf_counter() - tw))
            _flush_stats()
            if "error" in holder:
                raise RuntimeError(
                    f"async gated-audio download failed: {holder['error']}")
            return holder["host"]

        for row, i in enumerate(order):
            results[i] = LazyAudio(_join, row, n_outs[row],
                                   flush=_flush_stats, start=_start,
                                   started=lambda: bool(holder.get("started")))
            row_map[i] = row
        return results, batch, row_map
    host = to_host(q_down)
    _mark("download", t0)
    for row, i in enumerate(order):
        results[i] = host[row, : n_outs[row]]
        row_map[i] = row
    return (results, batch, row_map) if return_device else results
