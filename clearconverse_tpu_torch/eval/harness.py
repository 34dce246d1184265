"""Config-sweep evaluation harness.

Parity target: ``back/test.py`` (B22, SURVEY.md §2.1) — same sweep-grid
structure (base config + single-parameter variations + 3 combo presets,
test.py:1487-1602), per-(file, config) run directories, ``evaluation.csv``,
``results_summary.json`` and a side-by-side ``transcript_comparison.html``.

Upgrade over the reference: the CSV's scoring columns are COMPUTED (WER/DER
vs optional ground-truth files, plus measured RTFx) instead of blank manual
1-5 columns (test.py:1198-1207); the manual columns are still emitted for
workflow compatibility. Models load ONCE across the whole sweep — the
reference reloads every model for every config (test.py:1266).

The port's copy of the JAX package's eval/harness.py: the same grid and
artifacts, run on the port's ``TranscriptionEngine`` with
``torch_config_from_env()`` on ``device`` (``cuda`` unless the caller asks
for the CPU), or on the dev stand-ins on the CPU under
``CC_TPU_FAKE_MODELS=1``.
"""

from __future__ import annotations

import csv
import dataclasses
import html
import json
import math
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from clearconverse_tpu_torch.config import Config
from clearconverse_tpu_torch.eval.der import diarization_error_rate
from clearconverse_tpu_torch.eval.wer import word_error_rate_detail

SWEEP_PARAMS: Dict[str, List[float]] = {
    # Same parameters and values as test.py:1502-1572.
    "min_segment_duration": [0.35, 0.55],
    "overlap_threshold": [0.40, 0.60],
    "merge_gap_threshold": [0.40, 0.60],
    "min_overlap_duration_for_separation": [0.50, 0.70],
    "speaker_embedding_threshold": [0.50, 0.80],
    "noise_reduction_amount": [0.30, 0.70],
    "sliding_window_size": [0.60, 1.00],
    "sliding_window_step": [0.30, 0.50],
    "secondary_diarization_threshold": [0.40, 0.70],
}

PRESETS: List[Dict[str, float]] = [
    # test.py:1577-1602: fast-exchange / clean-speech / high-overlap presets.
    {"min_segment_duration": 0.35, "overlap_threshold": 0.40,
     "merge_gap_threshold": 0.40, "sliding_window_size": 0.60,
     "sliding_window_step": 0.30, "secondary_diarization_threshold": 0.25},
    {"min_segment_duration": 0.55, "noise_reduction_amount": 0.70,
     "speaker_embedding_threshold": 0.45,
     "secondary_diarization_threshold": 0.35},
    {"overlap_threshold": 0.40, "min_overlap_duration_for_separation": 0.50,
     "sliding_window_size": 0.60, "sliding_window_step": 0.30},
]


def build_sweep_grid(limit: Optional[int] = None) -> List[Dict[str, float]]:
    """Base + one-param variations + presets (~22 configs)."""
    base = {"min_overlap_duration_for_separation": 0.60}  # test.py:65 default
    grid: List[Dict[str, float]] = [dict(base)]
    for param, values in SWEEP_PARAMS.items():
        for v in values:
            grid.append({**base, param: v})
    for preset in PRESETS:
        grid.append({**base, **preset})
    if limit and 0 < limit < len(grid):
        grid = grid[:limit]
    return grid


@dataclasses.dataclass
class RunResult:
    audio_file: str
    config_id: int
    overrides: Dict[str, float]
    transcript: str
    duration_s: float
    wall_s: float
    rtfx: float
    wer: Optional[float] = None
    der: Optional[float] = None
    # Alignment counts behind the WER: keep hallucination magnitude
    # visible when the empty-reference cap clamps the rate at 1.0.
    wer_insertions: Optional[int] = None
    hyp_words: Optional[int] = None
    # True when the sweep ran on dev stand-ins (CC_TPU_FAKE_MODELS=1):
    # metrics from fake models must never be mistaken for real-model
    # parity numbers, so every artifact row carries the flag.
    dev_models: bool = False


def _segments_from_result(result) -> List[Tuple[float, float, str]]:
    return [(s.start, s.end, s.speaker_id) for s in result["segments"]]


def load_reference_rttm(path: str) -> List[Tuple[float, float, str]]:
    """RTTM ground-truth loader (NIST format, what pyannote evaluates with)."""
    segs = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 8 and parts[0] == "SPEAKER":
                start, dur, spk = float(parts[3]), float(parts[4]), parts[7]
                segs.append((start, start + dur, spk))
    return segs


def run_sweep(audio_files: Sequence[str],
              output_dir: str,
              configs: Optional[List[Dict[str, float]]] = None,
              engine_factory=None,
              ground_truth_text: Optional[Dict[str, str]] = None,
              ground_truth_rttm: Optional[Dict[str, str]] = None,
              device="cuda") -> List[RunResult]:
    """Run the grid; write the reference's artifact set with computed
    metrics. ``engine_factory(config) -> engine`` lets tests inject fakes;
    without one the port's engine runs on ``device``."""
    configs = configs if configs is not None else build_sweep_grid()
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    results: List[RunResult] = []

    shared_models = None
    dev_models = False
    for ci, overrides in enumerate(configs):
        cfg = Config()
        for k, v in overrides.items():
            cfg = cfg.replace(**{k: v})
        if engine_factory is not None:
            engine = engine_factory(cfg)
        else:
            from clearconverse_tpu_torch.config import torch_config_from_env
            from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine
            if shared_models is None and \
                    os.environ.get("CC_TPU_FAKE_MODELS") == "1":
                # Dev/demo sweeps (same contract as serve/factory.py): the grid
                # runs on signal-processing stand-ins without checkpoints —
                # random-init real models find no speakers at default
                # thresholds, which makes an offline smoke meaningless.
                # LOUDLY marked: dev-mode WER/DER/RTFx are NOT parity
                # numbers (every summary row also carries dev_models=true).
                from clearconverse_tpu_torch.pipeline.dev_backend import DevModels
                shared_models = DevModels()
                dev_models = True
                print("WARNING: CC_TPU_FAKE_MODELS=1 — sweeping DEV model "
                      "stand-ins; metrics do not reflect real checkpoints")
            # TranscriptionEngine.__init__ re-points the shared bundle's
            # config at THIS grid config (bundle-read fields like
            # condition_on_previous_text would otherwise stay frozen at
            # config_00's values across the sweep).
            engine = TranscriptionEngine(cfg, torch_config_from_env(),
                                         models=shared_models,
                                         device="cpu" if dev_models else device)
            shared_models = engine.models  # load once across the sweep
        for af in audio_files:
            run_dir = out / f"config_{ci:02d}" / Path(af).stem
            run_dir.mkdir(parents=True, exist_ok=True)
            if not engine.models_are_loaded():
                engine.load_models_with_progress()
            t0 = time.perf_counter()
            res = engine.process_file(af)
            wall = time.perf_counter() - t0
            transcript = ""
            if res is not None:
                transcript, _ = engine._write_outputs(
                    res, str(run_dir), False, lambda *_: None)
                transcript = transcript or ""
            # The engine already measured the audio; re-reading the file
            # (and only for .wav — other formats would get duration 0 and a
            # bogus RTFx 0.00) would be wrong and a redundant read.
            dur = float(res["metadata"].get("duration", 0.0)) if res else 0.0

            rr = RunResult(af, ci, overrides, transcript, dur, wall,
                           dur / wall if wall > 0 else 0.0,
                           dev_models=dev_models)
            if ground_truth_text and af in ground_truth_text:
                hyp_text = " ".join(
                    line for line in transcript.split("\n")
                    if line and not line.startswith("["))
                # language selects the normalizer (English whisper
                # normalizer vs language-agnostic light); the detail counts
                # keep hallucination magnitude visible past the
                # empty-reference WER cap.
                detail = word_error_rate_detail(
                    ground_truth_text[af], hyp_text,
                    language=getattr(engine.torch_config, "language", None))
                rr.wer = detail["wer"]
                rr.wer_insertions = detail["insertions"]
                rr.hyp_words = detail["hyp_words"]
            if ground_truth_rttm and af in ground_truth_rttm and res:
                rr.der = diarization_error_rate(
                    load_reference_rttm(ground_truth_rttm[af]),
                    _segments_from_result(res))["der"]
            results.append(rr)
    _write_artifacts(out, results)
    return results


def _write_artifacts(out: Path, results: List[RunResult]) -> None:
    # evaluation.csv — computed columns + the reference's manual ones.
    with open(out / "evaluation.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["Audio File", "Config ID", "Overrides", "RTFx", "WER",
                    "DER", "Speaker Attribution Score (1-5)",
                    "Overlap Handling Score (1-5)", "False Speaker Changes"])
        for r in results:
            w.writerow([os.path.basename(r.audio_file), r.config_id,
                        json.dumps(r.overrides), f"{r.rtfx:.2f}",
                        "" if r.wer is None else f"{r.wer:.4f}",
                        "" if r.der is None else f"{r.der:.4f}", "", "", ""])

    def _finite(v):
        # DER is inf for hallucinated speech over an unscored reference
        # (der.py); json.dump would emit a bare `Infinity` token that strict
        # parsers (JS JSON.parse, jq) reject — stringify non-finite floats
        # at the artifact boundary. Recurses so a non-finite value nested
        # inside the config-overrides dict (or any list) is caught too.
        if isinstance(v, float) and not math.isfinite(v):
            return repr(v)
        if isinstance(v, dict):
            return {k: _finite(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [_finite(x) for x in v]
        return v

    with open(out / "results_summary.json", "w") as fh:
        json.dump([{k: _finite(v) for k, v in dataclasses.asdict(r).items()}
                   for r in results], fh, indent=2)

    # transcript_comparison.html — side-by-side per audio file.
    by_file: Dict[str, List[RunResult]] = {}
    for r in results:
        by_file.setdefault(r.audio_file, []).append(r)
    rows = ["<html><head><meta charset='utf-8'><title>Transcript comparison"
            "</title><style>td{vertical-align:top;border:1px solid #ccc;"
            "padding:6px;font-family:monospace;white-space:pre-wrap}"
            "th{background:#eee}</style></head><body>"]
    for af, rs in by_file.items():
        rows.append(f"<h2>{html.escape(os.path.basename(af))}</h2><table><tr>")
        rows.extend(f"<th>config {r.config_id}<br>RTFx {r.rtfx:.1f}</th>"
                    for r in rs)
        rows.append("</tr><tr>")
        rows.extend(f"<td>{html.escape(r.transcript)}</td>" for r in rs)
        rows.append("</tr></table>")
    rows.append("</body></html>")
    (out / "transcript_comparison.html").write_text("".join(rows),
                                                    encoding="utf-8")
