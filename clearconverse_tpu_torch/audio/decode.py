"""Container decode and canonical loading.

``ensure_wav_format`` (back/api.py:530-568) and ``load_audio``
(back/api.py:799-838): WAV decodes in audio/wav.py; other containers go
through an ffmpeg subprocess when the binary exists, keeping the original
path on failure. ``load_audio_many`` is the engine's batched load: the
files read in parallel into one reused int16 staging batch, one upload of
that batch as it is, one gate + normalize over the padded batch on the device,
and a download of the gated batch that starts only when a caller first
reads the bytes (``LazyAudio``).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Tuple

import numpy as np
import torch

from clearconverse_tpu_torch.audio import denoise as _denoise
from clearconverse_tpu_torch.audio.resample import resample
from clearconverse_tpu_torch.audio.wav import is_mono_i16, read_wav, scan_layout
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


# Files are read into the staging batch by at most this many threads: file
# reads release the interpreter lock.
_READ_WORKERS = min(8, os.cpu_count() or 1)


class _Staging:
    """The process's host batch of int16 rows that ``load_audio_many`` reads
    files into: one flat buffer viewed as [K, T], page-locked when the batch
    goes to a CUDA device, reused by every call and grown when a larger
    batch is asked for. ``lock`` is held from the first row written until
    the upload is enqueued; ``uploaded`` is the CUDA event recorded after
    that upload, waited on before the buffer is written again."""

    def __init__(self):
        self.lock = threading.Lock()
        self.flat = None
        self.pinned = False
        self.uploaded = None

    def take(self, K: int, T: int, pinned: bool):
        """→ (int16 [K, T] tensor over the buffer, whether it was reused)."""
        if self.uploaded is not None:
            self.uploaded.synchronize()
            self.uploaded = None
        n = K * T
        reused = (self.flat is not None and self.flat.numel() >= n
                  and (self.pinned or not pinned))
        if not reused:
            self.flat = None    # the old buffer goes back before the new one
            self.flat = torch.empty(n, dtype=torch.int16, pin_memory=pinned)
            self.pinned = pinned
        return self.flat[:n].view(K, T), reused


_STAGING = _Staging()
_POOL = None
_POOL_LOCK = threading.Lock()


def _reader_pool() -> ThreadPoolExecutor:
    """The process's reader threads, made at first use."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(_READ_WORKERS,
                                       thread_name_prefix="cc-wav-read")
        return _POOL


def _after_fork_in_child():
    # A forked child has none of its parent's threads, and the buffer may
    # be pinned by the parent's CUDA context: it starts afresh.
    global _STAGING, _POOL, _POOL_LOCK
    _STAGING, _POOL, _POOL_LOCK = _Staging(), None, threading.Lock()


os.register_at_fork(after_in_child=_after_fork_in_child)


@dataclasses.dataclass
class _Staged:
    """One call's batch in the staging buffer: ``rows`` int16 [K, T] (each
    row zero past its ``n_outs``), the path index of each row (``order``),
    and the float32 waves of the rows that were converted."""

    rows: torch.Tensor
    order: list
    n_outs: list
    converted: dict
    reused: bool


def _to_mono_float(path: str, target_sr: int, device) -> np.ndarray:
    """Any other WAV layout → float32 mono at ``target_sr`` (a resample runs
    on ``device``, on the calling thread's stream)."""
    samples, sr = read_wav(path)
    mono = samples.mean(axis=0).astype(np.float32)
    if sr == target_sr:
        return mono
    n = len(mono)
    padded = np.pad(mono, (0, _next_bucket(n, sr) - n))
    n_out = int(math.ceil(target_sr * n / sr))
    return resample(torch.from_numpy(padded).to(device), sr,
                    target_sr)[:n_out].cpu().numpy()


def _read_headers(paths):
    """Each path's (format, payload offset, bytes), or the exception that
    reading its header raised."""
    heads = []
    for p in paths:
        try:
            with open(p, "rb") as fh:
                heads.append(scan_layout(fh, p))
        except Exception as exc:  # noqa: BLE001 — raised on the caller's thread
            heads.append(exc)
    return heads


def _in_pool(fn, items, *args) -> list:
    """``fn(chunk, *args)`` over ``items`` split into at most
    ``_READ_WORKERS`` strided chunks on the reader pool → the results of
    every chunk's items, in ``items``' order."""
    n_jobs = min(len(items), _READ_WORKERS)
    futures = [_reader_pool().submit(fn, items[j::n_jobs], *args)
               for j in range(n_jobs)]
    wait(futures)      # every chunk ends before any chunk's error is raised
    out = [None] * len(items)
    for j, fut in enumerate(futures):
        out[j::n_jobs] = fut.result()
    return out


def _scan_files(paths, target_sr: int, device):
    """Phase one: every file's header, read on the reader pool, then, on
    the calling thread, the conversion of every file that is not mono
    16-bit PCM at ``target_sr`` → ({path index: (path, payload offset,
    bytes)} of the files read as they are, {path index: float32 wave} of
    the converted ones). A file that fails is logged and left out of both."""
    direct, converted = {}, {}
    wavs = []
    for i, p in enumerate(paths):
        try:
            wavs.append((i, ensure_wav_format(p)))
        except Exception as exc:  # noqa: BLE001 — per-file failure → None
            if is_fatal(exc):
                raise
            logger.error("load_audio failed for %s: %s", p, exc)
    heads = _in_pool(_read_headers, [p for _, p in wavs])
    for (i, p), head in zip(wavs, heads):
        try:
            if isinstance(head, Exception):
                raise head
            fmt, offset, nbytes = head
            if is_mono_i16(fmt):
                if nbytes % 2:
                    raise ValueError(f"{p}: an odd payload of {nbytes} "
                                     "bytes of 16-bit samples")
                if fmt[2] == target_sr:
                    direct[i] = (p, offset, nbytes)
                    continue
            converted[i] = _to_mono_float(p, target_sr, device)
        except Exception as exc:  # noqa: BLE001 — per-file failure → None
            if is_fatal(exc):
                raise
            logger.error("load_audio failed for %s: %s", p, exc)
    return direct, converted


def _read_rows(jobs, rows: np.ndarray):
    """Read each job's (row, path, offset, bytes) samples straight into its
    row of ``rows`` (little-endian, as the host is) and zero the row's tail
    → for each job, None or the OSError that kept its row from being read."""
    errors = []
    for row, path, offset, nbytes in jobs:
        dst = rows[row]
        n = nbytes // 2
        err = None
        try:
            view = memoryview(dst[:n]).cast("B")
            with open(path, "rb", buffering=0) as fh:
                fh.seek(offset)
                got = 0
                while got < nbytes:
                    k = fh.readinto(view[got:])
                    if not k:
                        raise OSError(f"{path}: the file ended {nbytes - got}"
                                      " bytes short of its samples")
                    got += k
        except OSError as exc:
            err = exc
        dst[n:] = 0
        errors.append(err)
    return errors


def _write_scaled(dst: np.ndarray, w: np.ndarray) -> None:
    """A float row pre-scaled to its own peak on the int16 grid (the gate is
    scale-invariant and the output is peak-normalized, so quiet sources
    keep 16-bit precision), zero past its end."""
    peak = max(float(np.max(np.abs(w))), 1e-12) if len(w) else 1e-12
    dst[: len(w)] = np.clip(np.round(w * (32767.0 / peak)), -32768,
                            32767).astype(np.int16)
    dst[len(w):] = 0


def _stage(direct: dict, converted: dict, target_sr: int,
           pinned: bool) -> "_Staged | None":
    """Phase two, under ``_STAGING.lock``: every loaded file gets its row in
    path order; the calling thread writes the converted rows, then the pool
    reads the others. A row whose read fails drops its file, and the batch
    is laid out again without it. None when no file loaded."""
    while direct or converted:
        order = sorted([*direct, *converted])
        n_outs = [direct[i][2] // 2 if i in direct else len(converted[i])
                  for i in order]
        rows, reused = _STAGING.take(len(order),
                                     _next_bucket(max(n_outs), target_sr),
                                     pinned)
        q = rows.numpy()
        for row, i in enumerate(order):
            if i in converted:
                _write_scaled(q[row], converted[i])
        jobs = [(row, *direct[i]) for row, i in enumerate(order)
                if i in direct]
        failed = [(job, exc) for job, exc in
                  zip(jobs, _in_pool(_read_rows, jobs, q)) if exc is not None]
        if not failed:
            return _Staged(rows, order, n_outs,
                           {i: converted[i] for i in order if i in converted},
                           reused)
        for (row, path, _, _), exc in failed:
            logger.error("load_audio failed for %s: %s", path, exc)
            del direct[order[row]]
    return None


def load_audio_many(paths, target_sr: int = TARGET_SR,
                    noise_reduction_amount: float = 0.5,
                    denoise: bool = True, return_device: bool = False,
                    stage_times=None, host_async: bool = False,
                    wire_info=None, device="cuda", staging_info=None):
    """Batched multi-file load: every file's header first (and the
    conversion of files that are not mono 16-bit PCM at ``target_sr``),
    then the others read in parallel straight into their rows of one
    reused int16 staging batch, one upload of that batch as it is and one
    gate + normalize over the padded batch on ``device``, and one download.

    Returns a list aligned with ``paths``: float32 [T] arrays (LazyAudio
    views with ``host_async`` and ``return_device``), or None for files that
    failed to load. With ``return_device=True`` also returns the gated
    device batch [K, T] and a path → row map (the engine's AudioStore).

    The batch goes to a CUDA device without blocking, from the page-locked
    staging buffer; to any other device as a copy of its rows.
    ``wire_info`` (a dict) receives what crossed the wire: format, width,
    bytes. ``staging_info`` (a dict) receives ``rows_direct`` (rows read
    straight into the staging batch), ``rows_converted`` and
    ``staging_reused`` (1 when the batch fit the buffer the process already
    had). ``stage_times`` (a dict) receives host_decode, upload_gate and
    download spans."""
    def _mark(key: str, t0: float) -> float:
        t1 = time.perf_counter()
        if stage_times is not None:
            stage_times[key] = stage_times.get(key, 0.0) + (t1 - t0)
        return t1

    device = torch.device(device)
    on_cuda = device.type == "cuda"
    t0 = time.perf_counter()
    results = [None] * len(paths)
    row_map = [None] * len(paths)
    direct, converted = _scan_files(paths, target_sr, device)

    with _STAGING.lock:
        staged = _stage(direct, converted, target_sr, pinned=on_cuda)
        if staged is None:
            return (results, None, row_map) if return_device else results
        order, n_outs = staged.order, staged.n_outs
        if wire_info is not None:
            n_bytes = staged.rows.numel() * 2
            wire_info.update(bytes_raw_int16=n_bytes, format="int16",
                             width=16, bytes_wire=n_bytes)
        if staging_info is not None:
            staging_info.update(
                rows_direct=len(order) - len(staged.converted),
                rows_converted=len(staged.converted),
                staging_reused=int(staged.reused))
        t0 = _mark("host_decode", t0)
        if on_cuda:
            up = staged.rows.to(device, non_blocking=True)
            _STAGING.uploaded = torch.cuda.Event()
            _STAGING.uploaded.record(torch.cuda.current_stream(device))
        else:
            up = staged.rows.clone()
    n_valid = torch.tensor(n_outs, dtype=torch.int32, device=device)
    batch, q_down = _denoise.gate_normalize_i16(
        up, noise_reduction_amount, n_valid, sr=target_sr,
        denoise=bool(denoise and noise_reduction_amount > 0))
    force_sync()
    t0 = _mark("upload_gate", t0)

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
