"""WER/DER parity recipe for the port.

Given converted checkpoints and an eval set of audio files with the
REFERENCE pipeline's recorded outputs, runs the port's engine and reports
WER / DER / RTFx, and with ``--levers`` the deltas of each opt-in perf
lever against that baseline:

    python -m clearconverse_tpu_torch.eval.parity \
        --models ./models --eval-set ./parity_set --out parity_report [--levers]

Eval-set layout (record these by running the reference app on the same
files; back/api.py run() writes transcript.txt per task):

    parity_set/
      sample1.wav            # input audio
      sample1.ref.txt        # reference transcript ([SPK] a.aas - b.bbs\\n...)
      sample1.ref.rttm       # optional reference diarization (RTTM lines)

Checkpoint layout consumed by ModelBundle (``eval/dress_rehearsal`` writes
the same layout with seeded weights):

    models/
      small.en.pt                          # openai-whisper small.en
      whisper-ft/model.safetensors         # optional ft overlay
      embedding/embedding_model.ckpt       # speechbrain/spkrec-ecapa-voxceleb
      segmentation/pytorch_model.bin       # pyannote/segmentation-3.0
      resepformer-ft/{encoder,masknet,decoder}.ckpt  # speechbrain resepformer

The engine runs on the card unless ``--device cpu``; ``CC_TPU_FAKE_MODELS=1``
runs the dev stand-ins on the CPU. A copy of the JAX package's
eval/parity.py; the report keeps its keys, except that no RTFx target is
carried.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

TRANSCRIPT_RE = re.compile(
    r"\[(?P<spk>[A-Z_0-9]+)\]\s+(?P<s>[\d.]+)s\s*-\s*(?P<e>[\d.]+)s\n"
    r"(?P<text>.*?)(?:\n\n|\Z)", re.S)


def parse_transcript(text: str) -> List[Tuple[float, float, str, str]]:
    """[(start, end, speaker, text)] from the reference transcript format
    (back/api.py:1253-1265)."""
    out = []
    for m in TRANSCRIPT_RE.finditer(text):
        out.append((float(m.group("s")), float(m.group("e")),
                    m.group("spk"), m.group("text").strip()))
    return out


def parse_rttm(path: str) -> List[Tuple[float, float, str]]:
    """One NIST RTTM parser for both eval surfaces (harness's)."""
    from clearconverse_tpu_torch.eval.harness import load_reference_rttm
    return load_reference_rttm(path)


def evaluate_file(engine, wav: str, ref_txt: str,
                  ref_rttm: Optional[str]) -> Dict:
    from clearconverse_tpu_torch.eval.der import diarization_error_rate
    from clearconverse_tpu_torch.eval.wer import word_error_rate_detail

    t0 = time.perf_counter()
    result = engine.process_file(wav)
    elapsed = time.perf_counter() - t0
    if result is None:
        return {"file": os.path.basename(wav), "error": "engine returned None"}

    hyp_rows = [(s.start, s.end, s.speaker_id, s.transcription)
                for s in result["segments"]]
    ref_rows = parse_transcript(Path(ref_txt).read_text())

    hyp_text = " ".join(t for *_, t in hyp_rows)
    ref_text = " ".join(t for *_, t in ref_rows)
    # The normalizer follows the model's language; the detail counts keep
    # hallucination magnitude visible past the empty-reference cap.
    wer_d = word_error_rate_detail(
        ref_text, hyp_text,
        language=getattr(engine.torch_config, "language", None))
    wer = wer_d["wer"]

    ref_d = (parse_rttm(ref_rttm) if ref_rttm
             else [(s, e, spk) for s, e, spk, _ in ref_rows])
    hyp_d = [(s, e, spk) for s, e, spk, _ in hyp_rows]
    der = diarization_error_rate(ref_d, hyp_d)["der"]

    return {"file": os.path.basename(wav),
            "wer": round(wer, 4), "der": round(der, 4),
            "wer_insertions": wer_d["insertions"],
            "hyp_words": wer_d["hyp_words"],
            "rtfx": round(result["metadata"]["duration"] / elapsed, 2),
            "duration_s": round(result["metadata"]["duration"], 2),
            "segments": len(hyp_rows)}


# Opt-in perf levers awaiting a quality sign-off: ``--levers`` runs the
# eval set once per lever and reports deltas against the baseline, so the
# sign-off is one command once real checkpoints exist.
LEVERS: Dict[str, Dict] = {
    "wire8": {"wire_bits": 8},                         # mu-law audio wire
    "cross_kv_int4": {"cross_kv_bits": 4},             # int4 cross-KV
    "bucketed_window": {"pad_to_full_window": False},  # bucket-length windows
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default="./models")
    ap.add_argument("--eval-set", required=True)
    ap.add_argument("--out", default="parity_report")
    ap.add_argument("--levers", action="store_true",
                    help="additionally evaluate each opt-in perf lever "
                    "(wire8 / int4 cross-KV / bucketed windows) and report "
                    "WER/DER/RTFx deltas vs the baseline run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from clearconverse_tpu_torch.config import Config, torch_config_from_env
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

    wavs = sorted(Path(args.eval_set).glob("*.wav"))
    pairs = []
    for wav in wavs:
        ref = wav.with_suffix("").as_posix() + ".ref.txt"
        if not os.path.exists(ref):
            print(f"skip {wav.name}: no {os.path.basename(ref)}")
            continue
        rttm = wav.with_suffix("").as_posix() + ".ref.rttm"
        pairs.append((str(wav), ref, rttm if os.path.exists(rttm) else None))
    if not pairs:
        print("no (wav, ref.txt) pairs found — see module docstring for the "
              "eval-set layout")
        return 2

    import dataclasses

    # Each run builds a FRESH engine and bundle: the bundle reads its
    # TorchConfig when it loads and decodes, and it carries state between
    # calls (the sampling seed advances with every decode), so sharing one
    # bundle across levers would blur the lever under test with the order
    # of the runs. The cost is one checkpoint load per lever.
    def run_rows(tc) -> List[Dict]:
        if os.environ.get("CC_TPU_FAKE_MODELS") == "1":
            # Dev stand-ins (the branch of serve/factory.py): the whole
            # recipe, --levers included, runs without checkpoints. The
            # model-side levers (KV width, window padding) then change
            # nothing; wire8 still moves the result, because the mu-law
            # wire quantizes the audio before the stand-ins' features. The
            # mode validates the harness, not the models.
            from clearconverse_tpu_torch.pipeline.dev_backend import DevModels
            engine = TranscriptionEngine(Config(noise_reduction_amount=0.0),
                                         tc, models=DevModels(), device="cpu")
        else:
            engine = TranscriptionEngine(Config(), tc, model_dir=args.models,
                                         load_models_immediately=True,
                                         device=args.device)
        return [evaluate_file(engine, *p) for p in pairs]

    def means(rows: List[Dict]) -> Dict:
        ok = [r for r in rows if "error" not in r]
        if not ok:
            return {"mean_wer": None, "mean_der": None, "mean_rtfx": None}
        return {
            "mean_wer": round(sum(r["wer"] for r in ok) / len(ok), 4),
            "mean_der": round(sum(r["der"] for r in ok) / len(ok), 4),
            "mean_rtfx": round(sum(r["rtfx"] for r in ok) / len(ok), 2),
        }

    base_tc = torch_config_from_env()
    rows = run_rows(base_tc)
    summary = {
        "files": len(rows),
        **means(rows),
        "north_star": {"wer_der": "within 0.5 abs of reference"},
        "rows": rows,
    }

    if args.levers:
        base = means(rows)
        levers = {}
        for name, overrides in LEVERS.items():
            lrows = run_rows(dataclasses.replace(base_tc, **overrides))
            m = means(lrows)
            levers[name] = {
                **m,
                "delta_wer": (round(m["mean_wer"] - base["mean_wer"], 4)
                              if None not in (m["mean_wer"],
                                              base["mean_wer"]) else None),
                "delta_der": (round(m["mean_der"] - base["mean_der"], 4)
                              if None not in (m["mean_der"],
                                              base["mean_der"]) else None),
                "overrides": overrides,
                "rows": lrows,
            }
        summary["levers"] = levers
    Path(f"{args.out}.json").write_text(json.dumps(summary, indent=2))

    lines = ["# Parity report (SURVEY.md §6 baseline table)", "",
             "| file | WER | DER | RTFx | dur (s) | segs |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        if "error" in r:
            lines.append(f"| {r['file']} | — error: {r['error']} | | | | |")
        else:
            lines.append(f"| {r['file']} | {r['wer']} | {r['der']} | "
                         f"{r['rtfx']} | {r['duration_s']} | {r['segments']} |")
    lines += ["", f"mean WER {summary['mean_wer']} · mean DER "
              f"{summary['mean_der']} · mean RTFx {summary['mean_rtfx']}"]
    if summary.get("levers"):
        lines += ["", "## Opt-in perf levers (quality sign-off)", "",
                  "| lever | WER | ΔWER | DER | ΔDER | RTFx |",
                  "|---|---|---|---|---|---|"]
        for name, lv in summary["levers"].items():
            lines.append(f"| {name} | {lv['mean_wer']} | {lv['delta_wer']} "
                         f"| {lv['mean_der']} | {lv['delta_der']} | "
                         f"{lv['mean_rtfx']} |")
    Path(f"{args.out}.md").write_text("\n".join(lines) + "\n")
    brief = {k: v for k, v in summary.items() if k != "rows"}
    if "levers" in brief:
        brief["levers"] = {n: {k: v for k, v in lv.items() if k != "rows"}
                           for n, lv in brief["levers"].items()}
    print(json.dumps(brief))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
