"""The safetensors file format, read and written with numpy alone.

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` map of strings), then the tensors' raw
little-endian bytes, each at its offsets from the end of the header. The
port reads the ``whisper-ft/model.safetensors`` overlay with this module
rather than with the ``safetensors`` package, which a deployment may lack.

numpy has no bfloat16: ``load_file`` widens BF16 tensors to float32
(exactly: a bf16 value is the top half of an f32), and ``save_file`` writes
BF16 for bfloat16 torch tensors.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional

import numpy as np

# safetensors dtype name → numpy dtype (little-endian). BF16 is read as its
# raw 16-bit patterns and widened.
_DTYPES = {"F32": "<f4", "F16": "<f2", "BF16": "<u2", "I64": "<i8",
           "I32": "<i4", "I8": "i1"}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items() if k != "BF16"}


def load_file(path: str) -> Dict[str, np.ndarray]:
    """All tensors of a safetensors file as numpy arrays (BF16 → float32)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header length {n} runs past the file")
    header = json.loads(raw[8:8 + n].decode("utf-8"))
    data = memoryview(raw)[8 + n:]
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = info["dtype"]
        if dt not in _DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype {dt}")
        begin, end = info["data_offsets"]
        shape = tuple(int(s) for s in info["shape"])
        if not 0 <= begin <= end <= len(data):
            raise ValueError(f"{path}: {name} lies outside the data")
        arr = np.frombuffer(data[begin:end], dtype=_DTYPES[dt])
        if arr.size != int(np.prod(shape)):
            raise ValueError(f"{path}: {name} holds {arr.size} values for "
                             f"shape {shape}")
        arr = arr.reshape(shape)
        if dt == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.astype(arr.dtype.newbyteorder("="), copy=True)
    return out


def _raw(value):
    """(safetensors dtype, shape, little-endian bytes) of a numpy array or
    a torch tensor (bfloat16 tensors keep their 16-bit patterns)."""
    import torch
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return ("BF16", list(t.shape),
                    t.view(torch.int16).numpy().astype("<i2").tobytes())
        value = t.numpy()
    arr = np.asarray(value)
    name = _NAMES.get(arr.dtype.newbyteorder("<"))
    if name is None:
        raise ValueError(f"safetensors: unsupported dtype {arr.dtype}")
    return name, list(arr.shape), arr.astype(_DTYPES[name]).tobytes()


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write numpy arrays (or torch tensors) as one safetensors file, in
    name order, the header padded with spaces to a multiple of 8 bytes."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name in sorted(tensors):
        dt, shape, blob = _raw(tensors[name])
        header[name] = {"dtype": dt, "shape": shape,
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(text)))
        fh.write(text)
        for blob in blobs:
            fh.write(blob)
