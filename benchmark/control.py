"""Reads the numbers that set a cell's limits, over many seeds in one
process: the program's own reading, the control's (the reference one
precision below the configuration's in the program's place: fp8 operands
for Whisper, TF32 for PyanNet and ECAPA), and planted faults' (each breaks one model's answer).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 5 [--control] [--fault altered_token,altered_scores]

Each seed gets its own weights and inputs, the mix's warm work and a
short window at the cell's own load; the calls kept from it are held
against the reference as ``run.py`` holds them. One JSON line per seed:
``numbers`` (the program's, or the faulted program's) and, with
``--control``, ``control``. The benchmark's own runs never run this.
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
    from ccbench import check
    from ccbench.engine_cell import EngineCell, check_rng
    from ccbench.faults import FAULTS
    from ccbench.record import DecodeRecorder, SpeakerRecorder
    from ccbench.spec import Cell
    from ccbench.weights import reference_weights, speaker_weights

    cell = Cell(args.workload, bench_dir, root)
    kind, mix = cell.kind(), cell.traffic
    dev = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="ccbench_control_")
    try:
        ec = EngineCell(cell.config, dev, tmp)
        for seed in [int(s) for s in args.seeds.split(",")]:
            rec = DecodeRecorder(check_rng(seed), mix["check_calls"] - 1)
            spk = SpeakerRecorder(check_rng(seed, 8), mix["check_calls"] - 1)
            for name in (args.fault.split(",") if args.fault else []):
                model, fn = FAULTS[name]
                if model == "decode":
                    rec.fault = fn
                else:
                    spk.fault[model] = fn
            ec.load_seed(seed)
            inputs = kind.generate(mix, seed, ec.inputs_dir(seed))
            kind.warm(ec, mix, inputs)
            rec.active = spk.active = True
            win = kind.window(ec, mix, inputs, args.seconds)
            rec.active = spk.active = False
            rec.remove()
            spk.remove()
            w = check.whisper_readings(
                rec.kept(), ec.dims, reference_weights(ec.spec, seed, dev),
                args.control)
            s = check.speaker_readings(
                spk.kept("pyannet"), spk.kept("ecapa"), ec.speaker_dims,
                speaker_weights(ec.speaker_dims, seed, dev), args.control)
            print(json.dumps({
                "workload": args.workload, "seed": seed, "fault": args.fault,
                "attempted": win["attempted"], "failed": win["failed"],
                "numbers": {**w["numbers"], **s["numbers"]},
                "control": {**w["control"], **s["control"]},
                "rows": w["rows"], "tokens": w["tokens"],
                "seg_rows": s["seg_rows"], "embed_rows": s["embed_rows"]}),
                flush=True)
            del rec, spk, inputs
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
