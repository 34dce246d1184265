"""Traffic kind ``closed_loop_layout_files``: ``process_files`` passes back
to back, as ``closed_loop_files``, over files whose speech follows a
layout of the mix's own.

Mix parameters: ``files_per_pass`` WAVs of ``file_seconds``, cut into
turns of ``turn_seconds``; in every turn each of ``voices`` (a tone of
``hz`` at ``amplitude``) speaks from ``start`` to ``end`` seconds of the
turn, with raised-cosine edges of ``edge_seconds``; band-limited noise of
std ``noise_sigma`` under it all (``ccbench/traffic.py``). The seed draws
each tone's phase in each turn of each file, and the noise; lengths and
layout are the mix's, so every seed asks for the same work.
``pool_passes``, ``warm_passes`` and ``check_calls`` are
``closed_loop_files``' own, and so are ``warm``, ``window`` and ``unit``.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from ccbench import traffic


def _sibling(name: str):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        name + ".py")
    spec = importlib.util.spec_from_file_location(f"ccbench_kinds_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_loop = _sibling("closed_loop_files")
unit, warm, window = _loop.unit, _loop.warm, _loop.window


def make_file(rng: np.random.Generator, mix: dict) -> np.ndarray:
    """One file of the mix's layout plus noise."""
    sr = traffic.SR
    turn = int(mix["turn_seconds"] * sr)
    n = int(mix["file_seconds"] * sr)
    t = np.arange(turn) / sr
    edge = mix["edge_seconds"]
    x = np.zeros(n, np.float64)
    for t0 in range(0, n, turn):
        m = min(turn, n - t0)
        for v in mix["voices"]:
            y = np.clip(np.minimum((t - v["start"]) / edge,
                                   (v["end"] - t) / edge), 0.0, 1.0)
            gate = 0.5 - 0.5 * np.cos(np.pi * y)
            tone = np.sin(2 * np.pi * v["hz"] * t + rng.uniform(0, 2 * np.pi))
            x[t0: t0 + m] += (mix["amplitude"] * gate * tone)[:m]
    x = x.astype(np.float32)
    return x + traffic.band_limited_noise(rng, n, mix["noise_sigma"])


def generate(mix: dict, seed: int, out_dir: str) -> dict:
    """The pool of passes for ``seed``: lists of WAV paths under
    ``out_dir``."""
    rng = np.random.default_rng(seed)
    pool = []
    for p in range(mix["pool_passes"]):
        paths = []
        for i in range(mix["files_per_pass"]):
            path = os.path.join(out_dir, f"pass{p}_file{i}.wav")
            traffic.write_wav(path, make_file(rng, mix))
            paths.append(path)
        pool.append(paths)
    return {"pool": pool, "next": 0}
