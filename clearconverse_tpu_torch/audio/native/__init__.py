"""Native host-side packer of the lossless delta wire (``wavcodec.cc``),
built with ``g++`` at first use and loaded with ctypes. The packed wire runs
only where the batch goes to a device other than a CUDA one (audio/pack.py).

The library lands in the gitignored ``clearconverse_tpu_torch/_build/``
under a file name keyed on a hash of the source and the flags, as
``ops/build.py`` does for the CUDA sources: an edited source rebuilds, an
unchanged one is reused. Without ``g++`` (or when the build fails) ``get_lib``
returns None and logs a warning; ``audio/pack.pack_i16_batch`` then sends
raw int16, as the JAX package does, and ``load_audio_many``'s ``wire_info``
shows it.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from clearconverse_tpu_torch.ops.build import BUILD_DIR

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "wavcodec.cc")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(_FLAGS).encode())
    return str(BUILD_DIR / f"libwavcodec-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)      # atomic against a concurrent build
        return True
    except (subprocess.SubprocessError, OSError) as exc:
        logger.warning("wavcodec build failed: %s", exc)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The packer library, built on first use; None if it cannot be built
    or loaded (tried once per process)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            logger.warning("wavcodec load failed: %s", exc)
            return None
        i16 = ctypes.POINTER(ctypes.c_int16)
        i32 = ctypes.POINTER(ctypes.c_int32)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        lib.delta_scan.argtypes = [i16, ctypes.c_int64, ctypes.c_int64,
                                   i32, i32]
        lib.delta_scan.restype = ctypes.c_int
        lib.delta_pack.argtypes = [i16, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_int, u8, i32, i32]
        lib.delta_pack.restype = ctypes.c_int
        _lib = lib
        return _lib


def delta_scan(q: np.ndarray):
    """Max |first delta| and |second delta| over an int16 batch [K, T]
    (slots >= 2 of each row) in one C pass; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, np.int16)
    m1, m2 = ctypes.c_int32(0), ctypes.c_int32(0)
    rc = lib.delta_scan(q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                        q.shape[0], q.shape[1], ctypes.byref(m1),
                        ctypes.byref(m2))
    return (int(m1.value), int(m2.value)) if rc == 0 else None


def delta_pack(q: np.ndarray, order: int, width: int):
    """Delta + bit-pack of an int16 batch [K, T] into the audio/pack.py wire
    layout → (data [K, T*width//8] uint8, x0 [K] int32, e1 [K] int32);
    None without the library or for an unpackable shape."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q, np.int16)
    k, t = q.shape
    data = np.empty((k, t * width // 8), np.uint8)
    x0 = np.empty((k,), np.int32)
    e1 = np.empty((k,), np.int32)
    rc = lib.delta_pack(
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), k, t, order, width,
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        x0.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        e1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return (data, x0, e1) if rc == 0 else None
