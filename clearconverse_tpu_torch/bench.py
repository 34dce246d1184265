"""End-to-end RTFx benchmark of the port, on the card unless ``--device cpu``.

    python -m clearconverse_tpu_torch.bench [--batch 128] [--model-dir ./models]

The port of the root ``bench.py`` (the JAX bench, which stays as it is),
with its workloads and JSON keys so the two can be read side by side. The
default run prints three JSON lines, each a complete record: the first,
flushed the moment the hot path is measured, carries ``engine: {"status":
"pending"}`` so a run cut short still leaves a parsed number; the second
adds the ``engine`` block; the last is the merged record with every block.
The last line stays under 2,000 characters:
numbers are rounded to 3 significant places, and only the ``engine`` block
carries ``stage_seconds`` (its top-level stages).

Blocks:

  * hot path (the top-level ``value``): Whisper ``--model`` with seeded
    random weights; ``--batch`` rows of 30 s of seeded noise; log-mel (kernel
    K1), the encoder (kernel K2), ``--kv-bits`` cross-KV and
    ``--self-kv-bits`` self-KV, and ``--decode-tokens`` KV-cached steps in
    bf16 with EOT disabled (``eot=-1``), so random weights decode the same
    work as trained ones;
  * ``engine``: ``TranscriptionEngine.process_files`` on ``--engine-files``
    files of 60 s of ``synth_conversation_speech()`` tiled five times plus
    band-limited noise (so the default lossless packed wire engages), with
    lowered binarization thresholds, 64 tokens and one fallback rung, weights
    from ``--model-dir``; one cold and ``--engine-repeats`` timed passes,
    per-pass medians with the raw ``per_pass_s``;
  * ``engine_ref_default``: the same warm engine at the reference's default
    decode (temperature 0.1 → best_of 5 sampled replicas), after one more
    untimed pass that captures its decode graphs;
  * ``latency``: one 60 s file through the warm engine, request by request;
  * ``engine_overlap``: the overlap path (RE-SepFormer separation and
    best-source choice) on 60 s of ``synth_conversation()`` tiled five
    times per file, with ``min_speakers=2`` and the crafted
    frequency-selective PyanNet, whose weights find the synthetic overlaps
    (seeded random segmentation weights find none).

Each block reports the decode step time (``step_ms``: the token loop's time
per step, recorded by ``ModelBundle.decode_timer`` on one more, untimed pass,
since its spans end with a synchronize that the timed passes leave out; the
hot path's ``stage_ms`` comes from that pass too), the peak device memory of
its timed passes
(``torch.cuda.max_memory_allocated``), the launches of K1 and K2 in them,
the decode graphs' replays in the ``step_ms`` pass (``graph_replays``;
models/decode_graph.py, on the card only) and, in the hot path, the graphs
its warm-up call captured and their seconds (``graph_captures``,
``capture_s``), and the top line carries the card's ``name, power.limit``
from ``nvidia-smi``.

``_ensure_models`` writes the dress-rehearsal checkpoint set
(``eval/dress_rehearsal.populate``: real dims, formats and layout, seeded
values) into ``--model-dir`` when it holds no Whisper checkpoint
(``CC_BENCH_AUTOGEN_MODELS=0`` opts out); its outcome is the line's
``models`` key. The engine blocks run under a wall-clock budget
(``--budget`` / ``CC_BENCH_BUDGET_S``, default 2400 s from process start):
warm passes stop early and a block reports ``budget_truncated`` or
``skipped`` rather than outliving it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from clearconverse_tpu_torch.utils.precision import pin_bf16_reductions

_T0 = time.perf_counter()

# Leave this much headroom before the budget for the final print.
_MIN_ENGINE_S = 300.0
SR = 16000


def _remaining(budget_s: float) -> float:
    return budget_s - (time.perf_counter() - _T0)


def _sig(x, digits: int = 3):
    """Floats rounded to ``digits`` significant places, recursively."""
    if isinstance(x, float):
        if x == 0 or not math.isfinite(x):
            return x
        return round(x, digits - 1 - int(math.floor(math.log10(abs(x)))))
    if isinstance(x, dict):
        return {k: _sig(v, digits) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_sig(v, digits) for v in x]
    return x


def _dumps(line: dict) -> str:
    return json.dumps(_sig(line), separators=(",", ":"))


def _emit(line: dict) -> None:
    print(_dumps(line), flush=True)


def _card(device: torch.device) -> str:
    """``name, power.limit`` of the card as nvidia-smi prints them."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"{torch.cuda.get_device_name(device)} (nvidia-smi: {exc})"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _measured(device: torch.device, out: dict):
    """Resets the kernel launch counters and the peak-memory statistics,
    and writes the launches and the peak into ``out`` when the block ends."""
    from clearconverse_tpu_torch.ops import encoder_attention as k2
    from clearconverse_tpu_torch.ops import logmel as k1
    k1.mel_power.launches = 0
    k2.encoder_attention.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        yield
    finally:
        _sync(device)
        out["launches"] = {"k1": k1.mel_power.launches,
                           "k2": k2.encoder_attention.launches}
        out["peak_mem_gb"] = (torch.cuda.max_memory_allocated(device) / 1e9
                              if device.type == "cuda" else None)


def _step_ms(timer) -> float | None:
    """The token loop's time per step over a StageTimer's decode calls."""
    steps = timer.counts.get("token_loop_steps", 0)
    if not steps:
        return None
    return timer.as_dict().get("token_loop", 0.0) / steps * 1e3


def _graph_counts(timer, cold=None) -> dict:
    """The decode graphs' replays in ``timer``'s calls and, with ``cold``
    (the warm-up call's timer), the graphs it captured and their seconds:
    the token loop's graphs are captured on a key's first call (on the
    card; all 0 on the CPU)."""
    out = {"graph_replays": timer.counts.get("graph_replays", 0)}
    if cold is not None:
        out.update(graph_captures=cold.counts.get("graph_captures", 0),
                   capture_s=cold.as_dict().get("graph_capture", 0.0))
    return out


# ------------------------------------------------------------------ models

def _ensure_models(model_dir: str, device, budget_s: float = float("inf")) -> str:
    """Write the dress-rehearsal checkpoint set into ``model_dir`` when it
    holds no Whisper checkpoint, so the engine blocks measure the
    checkpoint-loaded path. Returns what happened ("present", "generated
    in N s", "off", "skipped: …" or "error: …"); an error is printed too."""
    from clearconverse_tpu_torch.config import Config
    if os.environ.get("CC_BENCH_AUTOGEN_MODELS") == "0":
        return "off"
    size = Config().whisper_model_size
    if (os.path.exists(os.path.join(model_dir, f"{size}.pt"))
            or os.path.exists(os.path.join(model_dir, "whisper", f"{size}.pt"))):
        return "present"
    if _remaining(budget_s) < _MIN_ENGINE_S + 120.0:
        msg = f"skipped: budget too deep to write {size}.pt into {model_dir}"
        print(f"bench: {msg}", file=sys.stderr, flush=True)
        return msg
    print(f"bench: no {size}.pt under {model_dir}; writing the "
          "dress-rehearsal checkpoint set", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    try:
        from clearconverse_tpu_torch.eval import dress_rehearsal
        dress_rehearsal.populate(model_dir, size, device=device)
    except Exception as exc:  # noqa: BLE001 — reported in the line
        msg = f"error: {type(exc).__name__}: {exc}"
        print(f"bench: writing the checkpoint set failed: {msg}",
              file=sys.stderr, flush=True)
        return msg[:200]
    return f"generated in {time.perf_counter() - t0:.1f} s"


# ---------------------------------------------------------------- hot path

def bench_hot_path(args, device: torch.device) -> dict:
    """Batched log-mel + encoder + KV-cached decode of a fixed token budget."""
    from clearconverse_tpu_torch.audio.mel import log_mel_auto
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.decoding import (
        DecodeOptions, build_prompt_batch, greedy_decode)
    from clearconverse_tpu_torch.models.whisper import model_dims
    from clearconverse_tpu_torch.utils.tracing import StageTimer

    dims = model_dims(args.model)
    model = init_whisper(dims, 0, device, torch.bfloat16)
    B, seg_sec = args.batch, 30.0
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(rng.standard_normal(
        (B, int(seg_sec * SR))).astype(np.float32) * 0.1).to(device)
    opts = DecodeOptions(max_tokens=args.decode_tokens, temperature=0.0,
                         eot=-1,  # never matches → fixed decode length
                         suppress_blank=False, compute_dtype=torch.bfloat16,
                         cross_kv_bits=args.kv_bits,
                         self_kv_bits=args.self_kv_bits)
    toks, lens = build_prompt_batch([[50257]] * B, 1, pad_id=50256)
    toks = torch.from_numpy(toks).to(device)
    lens = torch.from_numpy(lens).to(device)

    def pipeline(timer=None):
        with timer.stage("log_mel") if timer else contextlib.nullcontext():
            mel = log_mel_auto(audio, n_mels=dims.n_mels)
        return greedy_decode(model, mel, toks, lens, dims, opts, 1,
                             timer=timer)

    warm = StageTimer()             # warm-up; captures the decode graph
    pipeline(warm)
    _sync(device)
    block: dict = {}
    with _measured(device, block):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            pipeline()
        _sync(device)
        dt = time.perf_counter() - t0
    rtfx = B * seg_sec * args.iters / dt
    timer = StageTimer(sync=True)                  # one untimed split pass
    pipeline(timer)
    block.update({"rtfx": rtfx, "batch": B, "iters": args.iters,
                  "decode_tokens": args.decode_tokens,
                  "kv_bits": args.kv_bits, "self_kv_bits": args.self_kv_bits,
                  "step_ms": _step_ms(timer), **_graph_counts(timer, warm),
                  "stage_ms": {k: v * 1e3 for k, v in timer.as_dict().items()
                               if k != "token_loop"}})
    return block


# ----------------------------------------------------------------- engine

def _bl_noise(rng, n: int) -> np.ndarray:
    """Band-limited (box-8-filtered) white noise of σ 0.01."""
    w = rng.standard_normal(n + 8).astype(np.float32)
    c = np.cumsum(w, dtype=np.float64)
    b = ((c[8:] - c[:-8]) / 8.0)[:n]
    return (b * (0.01 / b.std())).astype(np.float32)


def engine_wavs(tmp: str, n_files: int, tiles: int = 5):
    """``n_files`` WAVs of ``synth_conversation_speech()`` tiled ``tiles``
    times plus band-limited noise, a different draw per file (the JAX
    bench's engine workload). Returns (paths, seconds per file)."""
    from clearconverse_tpu_torch.audio.wav import write_wav
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        synth_conversation_speech)
    rng = np.random.default_rng(0)
    base = np.tile(synth_conversation_speech(), tiles)
    paths = []
    for i in range(n_files):
        p = os.path.join(tmp, f"conv_{i}.wav")
        write_wav(p, base + _bl_noise(rng, base.shape[0]), SR)
        paths.append(p)
    return paths, base.shape[0] / SR


def overlap_wavs(tmp: str, n_files: int, tiles: int = 5):
    """``n_files`` WAVs of ``synth_conversation()`` (L, H, L, then L+H
    overlapping) tiled ``tiles`` times, file i scaled by 1 + 0.01 i."""
    from clearconverse_tpu_torch.audio.wav import write_wav
    from clearconverse_tpu_torch.pipeline.dev_backend import synth_conversation
    base = np.tile(synth_conversation(), tiles)
    paths = []
    for i in range(n_files):
        p = os.path.join(tmp, f"overlap_{i}.wav")
        write_wav(p, base * (1.0 + 0.01 * i), SR)
        paths.append(p)
    return paths, base.shape[0] / SR


def _run_passes(engine, paths, repeats: int, budget_s: float,
                est0: float = 60.0):
    """Timed warm passes with per-pass stage capture. Returns (per_pass_s,
    pass_stages, truncated, last results)."""
    per_pass, pass_stages, truncated, results = [], [], False, None
    for _ in range(repeats):
        # A pass costs about what the previous one did: stop with the passes
        # already banked rather than overrun the budget.
        est = max(per_pass) if per_pass else est0
        if per_pass and _remaining(budget_s) < est * 1.5:
            truncated = True
            break
        t0 = time.perf_counter()
        results = engine.process_files(paths)
        dt = time.perf_counter() - t0
        per_pass.append(dt)
        st = {k: v for k, v in engine.last_run_stage_times.items()
              if "." not in k}
        st["untracked"] = max(dt - sum(st.values()), 0.0)
        pass_stages.append(st)
    return per_pass, pass_stages, truncated, results


def _warm_report(per_pass, pass_stages, truncated, pass_audio: float,
                 stages: bool) -> dict:
    """The warm-pass block shared by every engine block: best and mean RTFx,
    the raw per-pass walls and, with ``stages``, the per-pass MEDIAN of each
    top-level stage over the passes it ran in (``stage_counts`` lists a
    stage that ran in fewer passes than ``per_pass_s``)."""
    out = {"rtfx_warm_best": pass_audio / min(per_pass),
           "rtfx_warm_mean": pass_audio * len(per_pass) / sum(per_pass),
           "warm_passes": len(per_pass), "per_pass_s": per_pass}
    if stages:
        med, counts = {}, {}
        for k in sorted({k for st in pass_stages for k in st}):
            vals = [st[k] for st in pass_stages if k in st]
            med[k] = statistics.median(vals)
            if len(vals) < len(pass_stages):
                counts[k] = len(vals)
        out["stage_seconds"] = dict(sorted(med.items(), key=lambda kv: -kv[1]))
        if counts:
            out["stage_counts"] = counts
    if truncated:
        out["budget_truncated"] = True
    return out


def _timed_passes(engine, paths, repeats, budget_s, pass_audio, device,
                  stages: bool = False):
    """``_run_passes`` with the kernel counters and the peak memory taken
    over the timed passes; then, budget allowing, one untimed pass with the
    bundle's decode timer for ``step_ms`` and the decode graphs' replays.
    → (the warm report, results)."""
    from clearconverse_tpu_torch.utils.tracing import StageTimer
    block: dict = {}
    with _measured(device, block):
        per_pass, pass_stages, truncated, results = _run_passes(
            engine, paths, repeats, budget_s)
    out = _warm_report(per_pass, pass_stages, truncated, pass_audio, stages)
    timer = StageTimer(sync=True)
    if _remaining(budget_s) >= max(per_pass) * 1.5:
        engine.models.decode_timer = timer
        try:
            engine.process_files(paths)
        finally:
            engine.models.decode_timer = None
    out.update(step_ms=_step_ms(timer), **_graph_counts(timer), **block)
    return out, results


def _engine_knobs(engine_config_kw: dict):
    """The engine blocks' TorchConfig: ``CC_TORCH_*`` overrides apply, then
    the bench's own knobs (lowered binarization thresholds so segments
    emerge from random weights; 64 tokens and one fallback rung, the cost of
    trained weights on these segments)."""
    from clearconverse_tpu_torch.config import torch_config_from_env
    return dataclasses.replace(torch_config_from_env(), diarization_onset=0.35,
                               diarization_offset=0.25, max_decode_tokens=64,
                               max_fallback_attempts=1, **engine_config_kw)


def _random_weights(load_source: dict) -> bool:
    """True when any family fell back to seeded random weights (the
    overlap block's crafted PyanNet is neither)."""
    return "random_init" in load_source.values()


def bench_engine(args, device, budget_s: float, share: dict, tmp: str) -> dict:
    """Full-pipeline RTFx: process_files over synthetic conversations."""
    from clearconverse_tpu_torch.config import Config
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

    paths, file_s = engine_wavs(tmp, args.engine_files, args.engine_tiles)
    cfg = Config(noise_reduction_amount=0.2,
                 temperature=args.engine_temperature)
    tc = _engine_knobs({})
    engine = TranscriptionEngine(cfg, tc, model_dir=args.model_dir,
                                 load_models_immediately=True, device=device)
    if not engine.models_are_loaded():
        raise RuntimeError("model load failed")
    engine.process_files(paths)                    # cold pass
    pass_audio = file_s * len(paths)
    out, results = _timed_passes(engine, paths, args.engine_repeats,
                                 budget_s, pass_audio, device, stages=True)
    load_source = dict(engine.models.load_source)
    share.update(engine=engine, paths=paths, pass_audio=pass_audio)
    out.update({
        "files": len(paths),
        "segments_per_pass": sum(len(r["segments"]) for r in results if r),
        "wire": {k: v for k, v in engine.last_run_wire.items()
                 if k != "bytes_raw_int16"},
        "knobs": {"temperature": cfg.temperature,
                  "max_decode_tokens": tc.max_decode_tokens,
                  "max_fallback_attempts": tc.max_fallback_attempts,
                  "best_of": tc.best_of,
                  "diarization_onset": tc.diarization_onset,
                  "diarization_offset": tc.diarization_offset,
                  "pad_to_full_window": tc.pad_to_full_window,
                  "cross_kv_bits": tc.cross_kv_bits,
                  "self_kv_bits": tc.self_kv_bits,
                  "wire_bits": tc.wire_bits,
                  "transcription_batch_size": cfg.transcription_batch_size,
                  "random_weights": _random_weights(load_source),
                  "load_source": load_source}})
    return out


def bench_ref_default(engine, paths, pass_audio: float, budget_s: float,
                      repeats: int, device) -> dict:
    """The same warm engine at the reference's default decode: scalar
    temperature 0.1 → best_of sampled replicas on every first decode."""
    prev = engine.config.temperature
    engine.config.temperature = 0.1
    try:
        engine.process_files(paths)   # captures the t > 0 decode graphs
        out, _ = _timed_passes(engine, paths, repeats, budget_s, pass_audio,
                               device)
        out["knobs"] = {"temperature": 0.1,
                        "best_of": engine.torch_config.best_of}
        return out
    finally:
        engine.config.temperature = prev


def bench_latency(engine, repeats: int, tiles: int, device, tmp: str) -> dict:
    """Wall clock from file path to finished transcript for ONE file
    through the warm engine, request by request: what one user waits."""
    (path,), _ = engine_wavs(tmp, 1, tiles)
    engine.process_files([path])                   # warm-up at B=1 shapes
    block: dict = {}
    laps = []
    with _measured(device, block):
        for _ in range(repeats):
            t0 = time.perf_counter()
            engine.process_files([path])
            laps.append(time.perf_counter() - t0)
    return {"latency_best_s": min(laps), "latency_mean_s": sum(laps) / len(laps),
            **block}


def bench_overlap(args, device, budget_s: float, tmp: str) -> dict:
    """The overlap engine on synth_conversation() files: separation of the
    overlap spans and best-source choice, the crafted PyanNet."""
    from clearconverse_tpu_torch.config import Config
    from clearconverse_tpu_torch.models.pyannet import PyannetDims
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        craft_pyannet_freq_params)
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

    paths, file_s = overlap_wavs(tmp, args.engine_files, args.engine_tiles)
    engine = TranscriptionEngine(
        Config(noise_reduction_amount=0.2, min_speakers=2), _engine_knobs({}),
        model_dir=args.model_dir, load_models_immediately=True, device=device)
    if not engine.models_are_loaded():
        raise RuntimeError("model load failed")
    b = engine.models
    b._pyannet, b._pyannet_dims = craft_pyannet_freq_params(PyannetDims(),
                                                            device=device)
    b.load_source["pyannet"] = "crafted"
    engine.process_files(paths)                    # cold pass
    pass_audio = file_s * len(paths)
    out, results = _timed_passes(engine, paths, args.engine_repeats,
                                 budget_s, pass_audio, device)
    out.update({"files": len(paths),
                "overlap_segments_per_pass": sum(
                    sum(s.is_overlap for s in r["segments"])
                    for r in results if r),
                "random_weights": _random_weights(b.load_source)})
    return out


# ------------------------------------------------------------------- main

def _block(fn, *a):
    """A block's result, or {"error": ...} so the merged line still prints."""
    try:
        return fn(*a)
    except Exception as exc:  # noqa: BLE001 — reported in the line
        return {"error": f"{type(exc).__name__}: {exc}"[:200]}


def _env_budget() -> float:
    # A malformed CC_BENCH_BUDGET_S must not crash the bench before the
    # hot-path line prints.
    try:
        return float(os.environ.get("CC_BENCH_BUDGET_S", "2400"))
    except ValueError:
        print("bench: ignoring malformed CC_BENCH_BUDGET_S="
              f"{os.environ['CC_BENCH_BUDGET_S']!r}; using 2400",
              file=sys.stderr)
        return 2400.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--model", default="small.en",
                    help="Whisper size of the hot path (tiny..large-v3-turbo, "
                    ".en variants)")
    ap.add_argument("--batch", type=int, default=128,
                    help="30 s rows per hot-path call")
    ap.add_argument("--decode-tokens", type=int, default=96,
                    help="tokens decoded per row (~3.2 tokens/s of speech)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--kv-bits", type=int, default=8, choices=(16, 8, 4),
                    help="cross-attention KV width of the hot path")
    ap.add_argument("--self-kv-bits", type=int, default=16, choices=(16, 8),
                    help="self-attention cache width of the hot path")
    ap.add_argument("--engine-files", type=int, default=8,
                    help="synthetic conversations per engine pass")
    ap.add_argument("--engine-repeats", type=int, default=3,
                    help="timed passes per engine block")
    ap.add_argument("--engine-tiles", type=int, default=5,
                    help="12 s conversation repeats per file (5 = 60 s)")
    ap.add_argument("--latency-repeats", type=int, default=4)
    ap.add_argument("--engine-temperature", type=float, default=0.0,
                    help="0.1 = the reference's default decode (best_of 5)")
    ap.add_argument("--budget", type=float, default=_env_budget(),
                    help="wall-clock budget in seconds from process start "
                    "(CC_BENCH_BUDGET_S)")
    ap.add_argument("--model-dir", default="./models",
                    help="checkpoints of the engine blocks (the engines' own "
                    "default)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--skip-engine", action="store_true",
                    help="hot path only (also CC_BENCH_SKIP_ENGINE=1)")
    ap.add_argument("--engine-only", action="store_true",
                    help="the engine block alone")
    ap.add_argument("--latency", action="store_true",
                    help="the single-file latency alone")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device is available; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pin_bf16_reductions()
    with tempfile.TemporaryDirectory(prefix="cc_bench_") as tmp:
        return _run(args, device, _card(device), tmp)


def _run(args, device: torch.device, card: str, tmp: str) -> int:
    """The blocks ``args`` asks for, their WAV files under ``tmp``."""
    share: dict = {}
    if args.latency or args.engine_only:
        models = _ensure_models(args.model_dir, device, args.budget)
        if args.latency:
            def lat():
                bench_engine(dataclasses.replace(
                    args, engine_files=1, engine_repeats=1), device,
                    args.budget, share, tmp)
                return bench_latency(share["engine"], args.latency_repeats,
                                     args.engine_tiles, device, tmp)
            _emit({"metric": "engine_latency", "unit": "seconds",
                   "card": card, "models": models, "latency": _block(lat)})
            return 0
        line = {"metric": "engine_only", "unit": "x_realtime_per_chip",
                "card": card, "models": models}
        _emit({**line, "engine": {"status": "pending"}})
        _emit({**line, "engine": _block(bench_engine, args, device,
                                        args.budget, share, tmp)})
        return 0

    hot = bench_hot_path(args, device)
    line = {"metric": f"whisper_{args.model.replace('.', '_').replace('-', '_')}_rtfx",
            "value": hot.pop("rtfx"), "unit": "x_realtime_per_chip",
            "card": card, "hot_path": hot}
    run_engine = (not args.skip_engine
                  and os.environ.get("CC_BENCH_SKIP_ENGINE") != "1")
    if not run_engine:
        _emit(line)
        return 0
    _emit({**line, "engine": {"status": "pending"}})
    line["models"] = _ensure_models(args.model_dir, device, args.budget)
    remaining = _remaining(args.budget)
    if remaining < _MIN_ENGINE_S:
        line["engine"] = {"skipped": "budget", "remaining_s": remaining}
    else:
        line["engine"] = _block(bench_engine, args, device, args.budget, share,
                                tmp)
    _emit(line)        # bank the engine numbers before the later blocks
    for key, need, fn, fa in (
            ("engine_ref_default", _MIN_ENGINE_S, bench_ref_default,
             (share.get("engine"), share.get("paths"), share.get("pass_audio"),
              args.budget, 2, device)),
            ("latency", _MIN_ENGINE_S / 2, bench_latency,
             (share.get("engine"), args.latency_repeats, args.engine_tiles,
              device, tmp)),
            ("engine_overlap", _MIN_ENGINE_S, bench_overlap,
             (args, device, args.budget, tmp))):
        if fn is bench_overlap:
            share.clear()               # free the first engine's weights
            if device.type == "cuda":
                torch.cuda.empty_cache()
        if fn is not bench_overlap and share.get("engine") is None:
            line[key] = {"skipped": "no engine"}
        elif _remaining(args.budget) < need:
            line[key] = {"skipped": "budget"}
        else:
            line[key] = _block(fn, *fa)
    _emit(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
