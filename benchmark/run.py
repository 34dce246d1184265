"""Runs one cell of the port's benchmark once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, traffic mix,
limits and per-layer metrics are found by name (``ccbench/spec.py``).
Set-up builds the engine, writes the seed's weights, makes the seed's
inputs and runs the mix's warm work; the window then measures for
``--seconds``; the model calls kept from it are held against the plain
references of the configuration's model families (``families/<name>.py``,
``ccbench/check.py``) once the program's state is freed. The
mix's kind (``kinds/<kind>.py``) makes the inputs and drives the window.
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones. The last line of standard output is the result; the
numbers compared, each beside its limit, are the last lines of standard
error.

``--control 1`` puts the control (the reference one precision below the
configuration's) in the program's place for every number compared: such
a run has to come out as not correct. The benchmark's own runs never set
it.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (BENCH_DIR, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# Top-level module names the measured process must never hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "clearconverse_tpu")


def forbidden_loaded() -> list:
    """Whole top-level names of ``sys.modules`` that are forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device: str = "cuda", need_card: bool = True,
         fault=None, bench_dir: str = BENCH_DIR, root: str = ROOT) -> int:
    """One run. ``device``, ``need_card`` and ``fault`` (names, comma
    separated, of faults the configuration's families plant) exist for the
    CPU tests; ``bench_dir`` and ``root`` let a test run a copy."""
    args = parse(argv)
    from ccbench.spec import Cell, readers
    cell = Cell(args.workload, bench_dir, root)
    import torch
    if need_card and (not torch.cuda.is_available()
                      or torch.cuda.device_count() < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {n}", file=sys.stderr)
        return 2
    dev = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="ccbench_")
    try:
        result = run_cell(cell, args, dev, tmp, fault, readers(cell))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = forbidden_loaded()
    if loaded:
        print(f"run.py: the process holds forbidden modules: {loaded}",
              file=sys.stderr)
        return 3
    checks = result["checks"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run_cell(cell, args, dev, tmp, fault, metric_readers) -> dict:
    import torch
    from ccbench.check import Check
    from ccbench.engine_cell import EngineCell
    from ccbench.record import KernelRecorder
    from clearconverse_tpu_torch.models import decode_graph

    kind, mix = cell.kind(), cell.traffic
    families = cell.families()
    ec = EngineCell(cell.config, families, dev, tmp)
    chk = Check(families, args.seed, mix["check_calls"] - 1,
                fault.split(",") if fault else ())
    kernels = KernelRecorder() if args.trace else None
    ec.load_seed(args.seed)
    inputs = kind.generate(mix, args.seed, ec.inputs_dir(args.seed))
    kind.warm(ec, mix, inputs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T0
    captures0 = decode_graph.COUNTS["captures"]
    chk.set_active(True)
    if kernels is not None:
        kernels.active = True
    win = kind.window(ec, mix, inputs, args.seconds)
    chk.set_active(False)
    if kernels is not None:
        kernels.active = False
    win["captures_in_window"] = decode_graph.COUNTS["captures"] - captures0
    run = {"window": win, "passes": win.get("passes"),
           **chk.run_fields(ec.dims)}
    if args.trace:
        run["k1_window"] = list(kernels.k1)
        run.update(ec.traced(lambda: kind.unit(ec, mix, inputs), kernels))
        kernels.remove()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ec.close()
    chk.remove()
    control = bool(args.control)
    got = chk.readings(ec.dims, args.seed, dev, control)
    numbers = got["control" if control else "numbers"]
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in cell.limits.items()}
    # A request whose answer never came is wrong, as is a number past its
    # limit or one the window left nothing to read for.
    correct = bool(win["attempted"] > 0 and win["failed"] == 0
                   and all(c["value"] is not None and c["value"] <= c["limit"]
                           for c in checks.values()))
    counts = ", ".join(f"{v} {k}" for k, v in got["counts"].items())
    print(f"run.py: {win.get('units', len(win.get('passes') or []))} units "
          f"in {win['window_s']:.3f} s, {win['attempted']} attempted; "
          f"checked {counts}{' against the control' if control else ''}; "
          f"card: {_card_line() if dev.type == 'cuda' else 'cpu'}",
          file=sys.stderr)
    if win.get("passes"):
        print(f"run.py: pass walls {[round(p['wall'], 3) for p in win['passes']]}, "
              f"segments {[p['segments'] for p in win['passes']]}",
              file=sys.stderr)
    if args.trace:
        metrics = {}
        units = {m["name"]: m["unit"] for m in cell.per_layer()}
        for name, read in metric_readers.items():
            v = read(run)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
    else:
        values = {**win["values"], "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end()}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics, "device": device}
    if args.trace:
        tr = run["trace"]
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.top_ops(10),
                            "idle_gaps": tr.idle_gaps(10)}
    out["checks"] = checks
    return out


if __name__ == "__main__":
    raise SystemExit(main())
