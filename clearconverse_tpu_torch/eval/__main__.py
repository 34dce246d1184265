"""Sweep CLI — the reference's ``python test.py`` contract
(back/test.py:1458-1664): --audio_file/--audio_dir, --limit, interactive
confirmation, per-run output dirs + evaluation artifacts, on the port's
engine (on the card unless ``--device cpu``; ``CC_TPU_FAKE_MODELS=1`` runs
the dev stand-ins on the CPU). Run as:

    python -m clearconverse_tpu_torch.eval --audio_file x.wav [--limit N]
           [--output_dir DIR] [--gt-text x.txt] [--gt-rttm x.rttm] [--yes]
           [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

from clearconverse_tpu_torch.eval.harness import build_sweep_grid, run_sweep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="clearconverse-eval")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--audio_file", help="single audio file to sweep")
    src.add_argument("--audio_dir", help="directory of .wav/.mp3 files")
    ap.add_argument("--limit", type=int, default=0,
                    help="cap the number of configurations")
    ap.add_argument("--output_dir", default="evaluation_results")
    ap.add_argument("--gt-text", help="ground-truth transcript for WER")
    ap.add_argument("--gt-rttm", help="ground-truth RTTM for DER")
    ap.add_argument("--yes", action="store_true",
                    help="skip the interactive confirmation")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.audio_file:
        files = [args.audio_file]
    else:
        files = sorted(
            os.path.join(args.audio_dir, f) for f in os.listdir(args.audio_dir)
            if f.lower().endswith((".wav", ".mp3")))
    if not files:
        print("no audio files found", file=sys.stderr)
        return 1

    # Ground-truth flags describe ONE file; pairing them with files[0] of a
    # directory listing would silently score the alphabetically first file
    # against someone else's transcript. Validate BEFORE the confirmation
    # prompt — everything needed is known here.
    if (args.gt_text or args.gt_rttm) and len(files) > 1:
        print("--gt-text/--gt-rttm require --audio_file (a single file); "
              f"got {len(files)} files from --audio_dir", file=sys.stderr)
        return 1

    configs = build_sweep_grid(limit=args.limit or None)
    print(f"{len(files)} file(s) × {len(configs)} configuration(s) "
          f"= {len(files) * len(configs)} runs → {args.output_dir}/")
    if not args.yes:
        answer = input("Proceed? [y/N] ").strip().lower()
        if answer not in ("y", "yes"):
            print("aborted")
            return 1

    gt_text = None
    if args.gt_text:
        with open(args.gt_text, encoding="utf-8") as fh:
            gt_text = {files[0]: fh.read()}
    gt_rttm = {files[0]: args.gt_rttm} if args.gt_rttm else None
    results = run_sweep(files, args.output_dir, configs=configs,
                        ground_truth_text=gt_text, ground_truth_rttm=gt_rttm,
                        device=args.device)
    best = max(results, key=lambda r: r.rtfx)
    print(f"done: {len(results)} runs; best RTFx {best.rtfx:.1f} "
          f"(config {best.config_id}); artifacts in {args.output_dir}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
