"""A copy of the benchmark with one tiny cell (Whisper tiny.en widths, one
short file a pass), so that the CPU tests drive a whole run in a minute."""

from __future__ import annotations

import json
import os
import shutil
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
TINY = "tiny-batch"
for _p in (ROOT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)


# The tiny cell's limits: above what sound runs read on the CPU and below
# what the control reads (test_ccbench_runs).
TINY_LIMITS = {"logprob_gap": 0.1, "seg_logprob_gap": 1e-3, "embed_gap": 1e-3}


def tiny_copy(dest: str, limits: dict = TINY_LIMITS, file_seconds: int = 12,
              program: bool = True) -> str:
    """``dest`` gets BENCHMARK.json and benchmark/ with the cell ``TINY``
    added as files and entries (and, with ``program``, a link to the
    program's package). Returns ``dest``."""
    shutil.copytree(BENCH_DIR, os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        manifest = json.load(fh)
    if program:
        os.symlink(os.path.join(ROOT, "clearconverse_tpu_torch"),
                   os.path.join(dest, "clearconverse_tpu_torch"))
    b = os.path.join(dest, "benchmark")
    with open(os.path.join(b, "configs", "whisper-small.en.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="whisper-tiny.en", program_model="tiny.en", d_model=384,
               encoder_layers=4, decoder_layers=4, encoder_attention_heads=6,
               decoder_attention_heads=6, encoder_ffn_dim=1536,
               decoder_ffn_dim=1536)
    cfg["engine"]["TorchConfig"]["max_decode_tokens"] = 8
    cfg["engine"]["Config"]["transcription_batch_size"] = 4
    _dump(cfg, b, "configs", "whisper-tiny.en.json")
    with open(os.path.join(b, "traffic", "files_64x30s.json")) as fh:
        mix = json.load(fh)
    mix.update(files_per_pass=1, file_seconds=file_seconds, pool_passes=1,
               warm_passes=1)
    _dump(mix, b, "traffic", "files_1_tiny.json")
    _dump(limits, b, "limits", TINY + ".json")
    manifest["configs"].append({"name": "whisper-tiny.en", "source": "test",
                                "file": "benchmark/configs/whisper-tiny.en.json",
                                "reduced": [], "why": "CPU tests"})
    manifest["workloads"].append({"name": TINY, "config": "whisper-tiny.en",
                                  "traffic": "files_1_tiny", "chips": 1,
                                  "why": "CPU tests"})
    for m in manifest["per_layer"] + manifest["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(TINY)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as fh:
        json.dump(manifest, fh, indent=1)
    return dest


def _dump(obj, *parts):
    with open(os.path.join(*parts), "w") as fh:
        json.dump(obj, fh, indent=1)
