"""Reads the numbers that set a cell's limits, over many seeds in one
process: the program's own reading, the control's (each family's
reference one precision below the configuration's in the program's
place), and planted faults' (each breaks one model's answer; a family
names its own in ``FAULTS``).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 5 [--control] [--fault altered_token,altered_scores]

Each seed gets its own weights and inputs, the mix's warm work and a
short window at the cell's own load; the calls kept from it are held
against the references as ``run.py`` holds them (``ccbench/check.py``).
One JSON line per seed: ``numbers`` (the program's, or the faulted
program's), with ``--control`` ``control``, and each family's counts of
what it checked. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (BENCH_DIR, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main(argv=None, device: str = "cuda", bench_dir: str = BENCH_DIR,
         root: str = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    import torch
    from ccbench.check import Check
    from ccbench.engine_cell import EngineCell
    from ccbench.spec import Cell

    cell = Cell(args.workload, bench_dir, root)
    kind, mix = cell.kind(), cell.traffic
    families = cell.families()
    faults = args.fault.split(",") if args.fault else ()
    dev = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="ccbench_control_")
    try:
        ec = EngineCell(cell.config, families, dev, tmp)
        for seed in [int(s) for s in args.seeds.split(",")]:
            chk = Check(families, seed, mix["check_calls"] - 1, faults)
            ec.load_seed(seed)
            inputs = kind.generate(mix, seed, ec.inputs_dir(seed))
            kind.warm(ec, mix, inputs)
            chk.set_active(True)
            win = kind.window(ec, mix, inputs, args.seconds)
            chk.set_active(False)
            chk.remove()
            got = chk.readings(ec.dims, seed, dev, args.control)
            print(json.dumps({
                "workload": args.workload, "seed": seed, "fault": args.fault,
                "attempted": win["attempted"], "failed": win["failed"],
                "numbers": got["numbers"], "control": got["control"],
                **got["counts"]}), flush=True)
            del chk, inputs
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
