"""Warm-up for serving deployments of the port.

What a cold server pays on its first requests is the kernels' ``nvcc``
builds (K1, K2), cuBLAS and cuDNN handle creation and algorithm choice for
each new shape, the caching allocator growing its pools, and, on the card,
the capture of the decode token loop's CUDA graph for every static key
(models/decode_graph.py: one graph per row bucket × encoder window × prompt
bucket × options, the counterpart of the JAX package's warm-up compiling its
decode programs).
This CLI drives every decode row bucket, then the real engine (the factory
the serve app uses) over synthetic conversations, so those costs land
before traffic:

    python -m clearconverse_tpu_torch.serve.warmup --durations 30,60 --files 1,8

Two drive kinds, in this order:
  * decode shapes — ``warm_decode_shapes``: transcribe_long_batch and
    transcribe_batch at every power-of-two row bucket × duration bucket,
    store-backed and from host arrays. On the card each drive captures the
    decode graph of its key; the largest bucket goes first, so the graphs'
    shared arena is sized once and no later drive replaces it. With
    ``beam_size > 1`` and a temperature ladder whose first rung is 0, each
    drive's first rung is beam search, so its beam keys are captured too;
  * engine passes — one ``process_files`` per (file count, duration):
    gate, segmentation, diarization, embeddings, profiles, overlap
    separation and the decode of every segment bucket the conversation
    produces. They come second: a key only they capture (a short bucket
    at another prompt length) would be dropped if a later decode-shape
    drive grew the arena.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np


def _default_engine():
    """The serve app's engine factory (serve/factory.py), so the warmed
    engine is the served one, the dev branch included (where warm-up is a
    smoke run of the host pipeline)."""
    from clearconverse_tpu_torch.serve.factory import default_engine_factory

    return default_engine_factory()


def warmup_conversation(duration_s: int, sr: int) -> np.ndarray:
    """Two-band synthetic conversation covering the decode duration
    buckets: the dev two-speaker layout (short exchanges + an overlap
    region, pipeline/dev_backend.synth_conversation) tiled to length, with
    a continuous mid-file low-band stretch long enough to hit the largest
    decode bucket, and the >30 s seek path when ``duration_s`` allows
    (stretch capped at 35 s)."""
    from clearconverse_tpu_torch.pipeline.dev_backend import synth_conversation

    base = synth_conversation()
    n = duration_s * sr
    reps = -(-n // len(base))
    x = np.tile(base, reps)[:n].copy()
    if duration_s >= 24:
        a = 12 * sr
        b = min((duration_s - 2) * sr, a + 35 * sr)
        t = np.arange(b - a) / sr
        x[a:b] = (0.5 * np.sin(2 * np.pi * 300.0 * t)).astype(np.float32)
    return x


def warm_decode_shapes(engine, drive: Callable[[str, Callable], None],
                       durations=(5.0, 10.0, 30.0)) -> Optional[dict]:
    """Drive the decode at every row bucket, in the variants production
    dispatches, through the deployment's own config.

    The engine pads decode batches to power-of-two row buckets
    (pipeline/bundle._row_bucket), and which buckets a request hits on the
    >30 s path depends on the decoded timestamps. So: store-backed
    transcribe_long_batch at every row bucket × prompt bucket (30 s
    windows), and transcribe_batch at every row bucket × duration bucket,
    store-backed (diarized segments of the original audio) and from host
    arrays (separated overlap clips), plus p64 prompts at the row
    extremes, each from the largest down (the first drive sizes the decode
    graphs' arena); a bundle that does not seek (Voxtral) gets no
    long windows. Returns ``decode_graph_stats`` of the bundle. A
    bundle that is not the port's ModelBundle (the dev backend) is
    skipped."""
    from clearconverse_tpu_torch.pipeline.bundle import (
        ModelBundle, StoreBatch, _row_bucket)
    from clearconverse_tpu_torch.pipeline.dev_backend import SR

    bundle = getattr(engine, "models", None)
    if not isinstance(bundle, ModelBundle):
        return None

    temp = engine.config.temperature
    cap = _row_bucket(max(int(engine.config.transcription_batch_size), 1))
    row_buckets = []
    r = cap
    while r >= 1:
        row_buckets.append(r)
        r //= 2
    cfg_durs = getattr(getattr(engine, "torch_config", None),
                       "duration_buckets", None)
    durations = tuple(sorted(cfg_durs if cfg_durs else durations,
                             reverse=True))
    rng = np.random.default_rng(0)

    def store_rows(n: int, dur_samples: int) -> StoreBatch:
        """n full-window rows in a fresh device store — the layout
        iter_store_batches produces for gated original audio."""
        audio = rng.standard_normal((n, dur_samples)).astype(np.float32) * 0.1
        store = bundle.make_store(audio, SR)
        return StoreBatch(store, np.arange(n), np.zeros(n, np.int32),
                          np.full(n, dur_samples, np.int32), dur_samples)

    # Prompt lengths land in every prompt bucket (bundle._prompt_batch:
    # 4/16/64/256) under both the GPT-2 BPE and the byte tokenizer.
    prompts = {"p256": "ctx " * 100, "p64": "ctx " * 9, "p16": "ctx " * 3,
               "p4": ""}
    for n in row_buckets if bundle.seeks else ():
        sb = store_rows(n, 30 * SR)
        lens = np.full(n, 30 * SR)
        for pname, prompt in prompts.items():
            drive(f"decode long-window rows={n} prompt={pname}",
                  lambda sb=sb, p=prompt, ln=lens, k=n:
                  bundle.transcribe_long_batch(sb, [p] * k, ln,
                                               temperature=temp))
    for n in row_buckets:
        for dur in durations:
            sb = store_rows(n, int(dur) * SR)
            drive(f"decode short store rows={n} duration={dur}s",
                  lambda sb=sb, k=n:
                  bundle.transcribe_batch(sb, [""] * k, temperature=temp))
            audio = rng.standard_normal((n, int(dur) * SR)) \
                .astype(np.float32) * 0.1
            drive(f"decode short host rows={n} duration={dur}s",
                  lambda a=audio, k=n:
                  bundle.transcribe_batch(a, [""] * k, temperature=temp))
    for n in (row_buckets[0], row_buckets[-1]):
        sb = store_rows(n, int(durations[0]) * SR)
        drive(f"decode short store rows={n} prompt=p64",
              lambda sb=sb, k=n:
              bundle.transcribe_batch(sb, [prompts["p64"]] * k,
                                      temperature=temp))
    return decode_graph_stats(bundle)


def decode_graph_stats(bundle) -> Optional[dict]:
    """The decode graphs' counts of ``bundle``'s transcriber (Whisper or
    Voxtral) on the card
    (captures, capture_s, replays, arena_allocs, ..., ``graphs``,
    ``beam_graphs``, ``arena_gb``); None elsewhere, and for a bundle that
    is not the port's ModelBundle."""
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle

    transcriber = getattr(bundle, "_whisper", None) or \
        getattr(bundle, "_voxtral", None)
    if (not isinstance(bundle, ModelBundle) or bundle.device.type != "cuda"
            or transcriber is None):
        return None
    from clearconverse_tpu_torch.models.decode_graph import graphs_for
    graphs = graphs_for(transcriber[0])
    # A key's last item is its DecodeOptions (decoding._graph_buffers).
    beam = sum(bool(key[-1].beam and key[-1].replicas > 1)
               for key in graphs.captured())
    return dict(graphs.stats, graphs=graphs.graphs, beam_graphs=beam,
                arena_gb=graphs.arena_bytes / 1e9)


def run_warmup(durations=(30, 60), file_counts=(1, 8),
               decode_shapes: bool = True,
               engine_factory: Optional[Callable] = None,
               log: Callable[[str], None] = print) -> List[dict]:
    """Drive every standard shape, the decode shapes first; returns one
    entry per drive with its wall-clock seconds (the first drive of a shape
    carries the set-up). On the card the last line logged is the decode
    graphs' counts after every drive: ``arena_allocs`` 1 means no graph
    captured on the way was dropped."""
    engine = (engine_factory or _default_engine)()
    from clearconverse_tpu_torch.audio.wav import write_wav
    from clearconverse_tpu_torch.pipeline.dev_backend import SR

    entries: List[dict] = []

    def drive(label: str, fn) -> None:
        t0 = time.perf_counter()
        ret = fn()
        # Only engine passes return a status string; decode drives return
        # their transcription results, which are not logged.
        extra = ret if isinstance(ret, str) else ""
        dt = time.perf_counter() - t0
        entries.append({"drive": label, "seconds": round(dt, 1)})
        log(f"  {label}: {dt:.1f}s{extra}")

    def engine_pass(paths):
        results = engine.process_files(paths)
        segs = sum(len(r["segments"]) for r in results if r)
        if segs == 0:
            # Without segments the decode never runs, so this drive warmed
            # only the front half (random-init models in --model-dir?).
            return ("  WARNING: 0 segments — decode NOT warmed "
                    "(random-init models?)")
        return f"  ({segs} segments)"

    if decode_shapes:
        warm_decode_shapes(engine, drive)
    with tempfile.TemporaryDirectory(prefix="cc_warm_") as tmp:
        for k in file_counts:
            for dur in durations:
                paths = []
                for i in range(k):
                    p = os.path.join(tmp, f"conv_{k}_{dur}_{i}.wav")
                    write_wav(p, warmup_conversation(int(dur), SR), SR)
                    paths.append(p)
                drive(f"engine files={k} duration={dur}s",
                      lambda paths=paths: engine_pass(paths))
    graphs = decode_graph_stats(getattr(engine, "models", None))
    if decode_shapes and graphs is not None:
        log(f"  decode graphs: {graphs}")
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Drive the serving engine over every standard shape. "
                    "The kernels' builds persist in the package's _build/; "
                    "the rest of the set-up is per process, which "
                    "CC_TPU_STARTUP_WARM=1 does inside the server.")
    ap.add_argument("--durations", default="30,60",
                    help="comma-separated file durations in seconds "
                    "(match your workload's length buckets)")
    ap.add_argument("--files", default="1,8",
                    help="comma-separated per-request file counts")
    ap.add_argument("--no-decode-shapes", action="store_true",
                    help="skip the per-row-bucket decode drives")
    args = ap.parse_args(argv)
    durations = tuple(int(s) for s in args.durations.split(",") if s)
    files = tuple(int(s) for s in args.files.split(",") if s)
    t0 = time.perf_counter()
    print(f"warming {len(durations) * len(files)} engine shapes "
          f"(durations={durations}, files={files}) ...")
    entries = run_warmup(durations, files,
                         decode_shapes=not args.no_decode_shapes)
    print(f"warmup done: {len(entries)} drives in "
          f"{time.perf_counter() - t0:.0f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
