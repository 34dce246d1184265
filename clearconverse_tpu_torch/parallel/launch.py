"""Spawn a group of ranks on one host and run one function on each.

``run_group(fn, devices, args)`` starts ``len(devices)`` processes (the
``spawn`` method: nothing of the caller's state is inherited), joins them
into one process group through a ``FileStore`` in a temporary directory (no
TCP port to race for), runs ``fn(devices, *args)`` on each and
returns rank 0's result. Every group has a time limit: a rank that fails
ends the others at once, and a group that outlives ``timeout_s`` is killed;
either raises in the caller. Each collective inside the group waits at
most ``parallel/mesh.COLLECTIVE_TIMEOUT_S``. ``fn`` must be importable by name from a
module that a fresh interpreter can import, and a script that calls
``run_group`` keeps its work under ``if __name__ == "__main__"``: each
spawned rank imports the caller's main module first.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence


def _rank_main(rank: int, fn: Callable, devices: List[str], args: tuple,
               workdir: str) -> None:
    import torch
    import torch.distributed as dist

    from clearconverse_tpu_torch.parallel.mesh import init_process_group

    try:
        if torch.device(devices[rank]).type == "cpu":
            torch.set_num_threads(1)     # ranks share the host's cores
        init_process_group(devices, init_method="file://" + os.path.join(
            workdir, "store"), rank=rank, world_size=len(devices))
        try:
            out = fn(devices, *args)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            with open(os.path.join(workdir, "result.pkl"), "wb") as fh:
                pickle.dump(out, fh)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def run_group(fn: Callable, devices: Sequence, args: tuple = (),
              timeout_s: float = 600.0) -> Any:
    """Run ``fn(devices, *args)`` on one spawned rank per entry of
    ``devices`` (a device may repeat) and return rank 0's result."""
    import multiprocessing as mp

    devices = [str(d) for d in devices]
    workdir = tempfile.mkdtemp(prefix="cc_ranks_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, fn, devices, tuple(args), workdir),
                         daemon=True)
             for r in range(len(devices))]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank group of {len(procs)} did not end "
                                   f"within {timeout_s:.0f} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        if failed:
            errs = []
            for r in failed:
                path = os.path.join(workdir, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as fh:
                        errs.append(f"rank {r}:\n{fh.read()}")
            raise RuntimeError(f"ranks {failed} failed (exit codes "
                               f"{[procs[r].exitcode for r in failed]})\n"
                               + "\n".join(errs))
        with open(os.path.join(workdir, "result.pkl"), "rb") as fh:
            return pickle.load(fh)
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=10)
        shutil.rmtree(workdir, ignore_errors=True)
