"""Traffic kind ``closed_loop_files``: ``TranscriptionEngine.process_files``
passes back to back, the batch cells.

Mix parameters: ``files_per_pass`` WAVs of ``file_seconds`` each of the
synthetic two-voice conversation plus band-limited noise of std
``noise_sigma`` (``ccbench/traffic.py``), ``pool_passes`` such sets that
the loop cycles through, ``warm_passes`` untimed passes at set-up, and
``check_calls`` calls of each checked model kept for the check.

A kind's module gives ``generate`` (the seed's inputs), ``warm`` (set-up's
untimed work), ``window`` (the measured loop and its end-to-end metrics)
and ``unit`` (one unit of work for the traced run).
"""

from __future__ import annotations

import os
import time

import numpy as np

from ccbench import traffic


def generate(mix: dict, seed: int, out_dir: str) -> dict:
    """The pool of passes for ``seed``: lists of WAV paths under
    ``out_dir``. Every seed gets the same sizes."""
    rng = np.random.default_rng(seed)
    pool = []
    for p in range(mix["pool_passes"]):
        paths = []
        for i in range(mix["files_per_pass"]):
            path = os.path.join(out_dir, f"pass{p}_file{i}.wav")
            traffic.write_wav(path, traffic.make_file(
                rng, mix["file_seconds"], mix["noise_sigma"]))
            paths.append(path)
        pool.append(paths)
    return {"pool": pool, "next": 0}


def unit(ec, mix: dict, inputs: dict):
    """One pass over the pool's next set of files: (results, wall)."""
    paths = inputs["pool"][inputs["next"] % len(inputs["pool"])]
    inputs["next"] += 1
    t0 = time.perf_counter()
    results = ec.engine.process_files(paths)
    return results, time.perf_counter() - t0


def warm(ec, mix: dict, inputs: dict) -> None:
    """The mix's untimed passes: every decode shape the loop reaches is
    captured here (a shape missed shows as decode.window_captures)."""
    for _ in range(mix["warm_passes"]):
        unit(ec, mix, inputs)


def window(ec, mix: dict, inputs: dict, seconds: float) -> dict:
    """Passes back to back while the window is open; each pass started
    inside it runs to its end. rtfx: the audio of the files completed over
    the time from the window's start to the last completion."""
    file_s = float(mix["file_seconds"])
    passes, audio_s, attempted, failed = [], 0.0, 0, 0
    t0 = time.perf_counter()
    t_last = t0
    while time.perf_counter() - t0 < seconds:
        results, wall = unit(ec, mix, inputs)
        t_last = time.perf_counter()
        ok = sum(r is not None for r in results)
        attempted += len(results)
        failed += len(results) - ok
        audio_s += ok * file_s
        passes.append({"wall": wall,
                       "stages": dict(ec.engine.last_run_stage_times),
                       "segments": sum(len(r["segments"])
                                       for r in results if r)})
    span = t_last - t0
    return {"passes": passes, "window_s": span, "attempted": attempted,
            "failed": failed,
            "values": {"rtfx": audio_s / span if span > 0 else 0.0}}
