#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (clearconverse_tpu_torch) on one card.

Phases, each fatal on failure:
  1. build   — compile every hand-written kernel from clearconverse_tpu_torch/
               csrc with nvcc (all at once); print the build seconds, ptxas's
               registers and spills, and each library's count of
               tensor-core instructions (HGMMA, HMMA) in its SASS;
  2. kernels — hold each kernel against its plain PyTorch version on the card
               at the main path's shapes (K1 on noise and on speech with
               silence; K1 and K2 bf16 also at the engine's batch of 32 and
               the bench hot path's of 128; K1 at the train CLI's one row
               and at a data rank's 4 rows of phase 17's 2x1 mesh; K2 at
               the heads a rank runs on the mesh paths (K2_MESH_SHAPES);
               K2 through its autograd Function at the train steps' shapes,
               sharded ones included (K2_GRAD_SHAPES), output and q/k/v
               gradients against autograd through the plain version), and
               time kernel, plain version and, where one exists, the single
               PyTorch library call; then the published RE-SepFormer's
               segment attention and FFN kernels against their plain
               versions at the overlap cell's call shape (16 rows of 8.3 s,
               1,776 segments): kernel, plain and bound ms; Voxtral's
               loop-step attention kernel (V1, ops/decode_attention.py)
               against its plain version at the voxtral-mini-batch cell's
               shape at step 64: kernel, plain, bound and, as a yardstick
               the port never calls, scaled_dot_product_attention ms;
  3. slice   — a 2-layer model at small.en's full width, f32: transcribe_batch
               at t=0 on the card (kernels) and on the CPU (plain versions);
               identical tokens and texts, encoder output and prefill logits
               within tolerance;
  4. main    — ModelBundle at small.en dims (seeded random weights: phases
               4–9 load from an empty model directory of their own, so what
               ./models holds does not change them) with the default TorchConfig knobs
               (bf16, int8 cross-KV, temperature 0.1, best_of 5) transcribes
               segments of a synthetic WAV as a host batch and as a StoreBatch,
               then once more at t=0; every kernel's launch count must rise;
  5. engine  — TranscriptionEngine.process_files (the user's entry point) on
               8 WAV files of 60 s at the full width of Whisper small.en,
               PyanNet and ECAPA (seeded random weights): one cold pass, two
               timed passes; RTFx,
               the stage split, segments per file, the audio wire, peak
               device memory and K1/K2 launches. It fails on a None file, an
               ERROR log record of the port, a wire other than raw int16
               with every file read straight into the staging batch,
               a >30 s segment without transcribe_long_batch, or a kernel that
               did not launch;
  6. engine card vs CPU — the same seeded speaker weights and a 2-layer
               small.en-width Whisper, f32, t=0: process_files on one 12 s
               file on the card and on the CPU; identical segments, labels and
               texts, embeddings within 1e-4.
  7. overlap — process_files on 8 WAV files of 60 s (synth_conversation()
               tiled five times, L+H overlap in every repeat) at full width:
               Whisper small.en with the default knobs (64 tokens, one
               rung), RE-SepFormer at SepformerDims(), ECAPA at EcapaDims(),
               the crafted frequency-selective PyanNet at PyannetDims(); one
               cold and two timed passes: RTFx, the stage split with
               overlap_reseg / separation / separate_dev, separation rows per
               batch, the overlap path's separation calls, real rows a call,
               reseg_calls and source_calls (its embedding calls),
               fused_attn_layers and fused_ffn_layers (0: the sketch),
               peak memory (the pass's and the separation calls'),
               one separation call's split (its intra-chunk attention
               against the whole call), K1/K2 launches; then one
               separate_batch with the published RE-SepFormer in the
               sketch's place, whose fused_attn_layers and fused_ffn_layers
               must read 16 and 24. It fails on a file
               without an is_overlap segment, separate_batch never running,
               a None file, an ERROR record of the port, or K1/K2 not
               launching.
               Then one transcribe_batch(word_timestamps=True) at full width:
               every word inside [0, 30] s with start <= end, starts in order;
  8. overlap card vs CPU — separate_batch at SepformerDims() on 3 rows at
               the 5 s bucket within rtol 1e-3 / atol 1e-4; process_files on
               24 s of synth_conversation() (crafted PyanNet, seeded ECAPA,
               full RE-SepFormer, 2-layer small.en-width Whisper f32 t=0):
               identical segments, overlap flags, labels and texts; word
               timestamps: identical words, times within one 0.02 s frame;
  9. serve   — the port's create_app on 127.0.0.1 with phase 7's engine:
               upload a WAV with overlaps, POST /transcribe/{id}, read
               /ws/progress/{id} to its end, GET /transcription/{id} and
               /download-pdf/{id}; it fails on a non-200, an error marker or
               a transcript without a [SPEAKER_ line;
 10. rehearsal — eval/dress_rehearsal.populate at full scale (small.en,
               EcapaDims(), PyannetDims(), SepformerDims(), 50,000 merges)
               into a temporary directory; a cold ModelBundle on it must
               report every family as checkpoint and BPETokenizer, its
               Whisper must equal the written module rounded to fp16 (max
               error 0), and one transcribe_batch at the default knobs runs
               on phase 4's segments; write and load seconds, file sizes;
 11. int4    — cross_kv_bits=4 on a 2-layer small.en-width model at f32
               t=0: identical tokens and texts card vs CPU; then phase 4's
               call at full width on the rehearsal bundle at int8 and int4
               in turns (8, 4, 4, 8): step time, peak memory, cross-KV
               bytes at rest;
 12. bench   — python -m clearconverse_tpu_torch.bench on the rehearsal
               directory at BENCH_ARGS in its own process: the last line
               parses and is under 2,000 characters, random_weights is
               false, every RTFx is > 0, K1 and K2 launched in the hot path;
 13. parity  — eval.parity --levers on two 24 s overlap files whose
               .ref.txt come from a fresh engine on the rehearsal
               checkpoints (with the crafted PyanNet in pyannote's format):
               the base row reads WER 0 and DER 0; the levers' deltas.
 14. train   — python -m clearconverse_tpu_torch.train in this process at
               small.en on the rehearsal checkpoints and 8 synthetic
               (wav, txt) pairs of 3-30 s, --batch 4 --steps 5 --max_tokens
               128, once plain and once with --remat --accum_steps 2: every
               printed loss finite, K2 launches >= 12 per step and K1 one
               per pair; step time, target tokens/s and peak memory of
               each. After the plain run, a fresh card ModelBundle (f32)
               on the base and the exported whisper-ft overlay must hold
               the trained module exactly (max error 0) and log no overlay
               fallback, and a plain step is split into forward, backward
               and AdamW (its state is freed before the remat run);
 15. train card vs CPU — 2 layers at small.en width, f32, one
               whisper_loss_sums with backward and one optimizer step from
               the same seeded weights and batch: loss within 1e-4
               relative, every gradient within 1e-3 of its largest entry,
               no parameter with a nonzero CPU gradient left at zero on the
               card (a K2 output without a backward), and the step's update
               (parameters after minus before) within 5e-6 of the CPU's
               wherever the CPU gradient exceeds 1e-3 of its parameter's
               largest (a first AdamW step moves such an entry by about
               lr = 1e-5, so a step left out or of the wrong sign fails);
 16. beam/language/native — beam_size 5 at t=0 on a 2-layer small.en-width
               f32 model: identical tokens and texts card vs CPU; then
               phase 4's segments at full width on the rehearsal bundle,
               beam_size 5 at t=0 and the default t=0.1 best_of 5 call in
               turns (K1 and K2 must launch); detect_language_from_audio on
               a 2-layer multilingual small model: identical ids card vs
               CPU; save_native then load_native of the rehearsal bundle:
               max error 0 and equal dims.
 17. mesh/quantize — two spawned ranks share the card over gloo (the
               compute mode must allow it): transcribe_batch at 1x2 (tensor
               parallel, K2 with 6 of small.en's 12 heads a rank) and at 2x1
               (data parallel) on a 2-layer small.en-width f32 model, t=0,
               phase 4's segments: tokens and texts identical to the 1x1
               card call, K1 and K2 launching on every rank; then
               entry.dryrun_multichip(2, "cuda") (a sharded train step,
               serving and process_files equal to 1x1, with overlap); then
               phase 4's segments on the rehearsal bundle with an int8
               decoder (ops/quantize) and its bf16 one in turns at B=8, 32
               and 128, t=0, 32 tokens: step time, peak memory, valid
               token ids, K1/K2 launches. Two ranks on one card share it,
               so no speed of the mesh is taken.
 18. decode graphs — on the rehearsal bundle's small.en, the token loop as
               CUDA graphs (models/decode_graph.py, the default route of
               every CUDA decode above) against the eager loop: identical
               tokens and texts at t=0 in bf16 and f32 on phase 4's rows,
               and an identical packed result on the bench hot path's
               B=128 call; then the hot path's call (96 tokens, EOT off) at
               B = 8, 32 and 128 in bf16, eager and graph in turns: step
               ms, call wall and RTFx, capture seconds, replays, stop-flag
               reads (at most ceil(steps / K) + 1), arena and graph-pool
               GB, peak memory against eager; with --profile, the card's
               busy share of one B=128 call on each route.
 19. beam graphs — on the rehearsal bundle's small.en, beam search as CUDA
               graphs (the default route of a CUDA beam_decode) against
               the eager beam loop: beam_size 5 at t=0 on phase 4's rows
               through transcribe_batch in bf16 and f32, every beam's
               tokens and the texts identical, K1 and K2 launching;
               then beam_decode at the hot path's shapes (30 s noise, 96
               steps, EOT suppressed, int8 cross-KV, bf16) at 8 and 32
               unique rows × 5 beams, eager and graph in turns: step ms,
               call wall and RTFx, capture, replays, stop-flag reads, the
               KV reorder's bytes a step, arena and pool GB, peak memory
               against eager.
 20. bf16 contract — the default bf16 decode against f32 on the card at
               full small.en width (the rehearsal checkpoint in bf16, as
               the bundle serves it, and in f32), t=0, int8 cross-KV, the
               graph route, on phase 4's voiced rows and on the hot path's
               30 s noise rows at B = 8, 32, 128: encoder mean and max
               |Δ|, prefill-logit mean |Δ| from one shared f32 encoder
               output and its argmax flips, token rows that differ; beam
               search (8 rows × 5) likewise; graph ≡ eager at B=8 in both
               dtypes; the tokens with cuBLAS's reduced-precision bf16
               reductions allowed; phase 18's graph step ms beside the
               step with bf16 logits and residual stream. Fails when the encoder's mean drift reaches the JAX
               package's bf16 bound (0.05) or graph and eager differ.
 21. warm-up — serve/warmup.run_warmup on the rehearsal checkpoints with
               the crafted PyanNet at the default knobs (decode shapes,
               then the engine passes), against the same drives with the
               engine passes first, each on a fresh engine: the decode
               graphs' arena_allocs, graphs, and the keys an engine pass
               captured that the end of the warm-up no longer holds. Fails
               unless run_warmup allocates the arena once and keeps them.
 22. voxtral — Voxtral Mini 3B at its published widths (seeded weights,
               bf16) at the voxtral-mini-batch cell's loop shape (32 unique
               rows x best_of 5, the 387-position prompt prefilled, step 64):
               one step eagerly under torch.profiler, its kernel time split
               into the attention block (the q/k/v outputs to o's input) and
               the rest, with the plain version (the step before V1) and
               with V1; the step as a CUDA graph timed by events, both ways;
               V1's step logits against the plain version's (fails at a
               log-probability gap of VX_STEP_GAP); then one decode
               call on the graph route (8 rows x best_of 5, 16 tokens) and
               its fused_attn_layers, which must be 30.
Every phase runs with the decode graphs' counts set to 0 before it; the
phases that decode on the card (GRAPH_PHASES) and every bench block must
have replayed graphs.
Then it prints the kernels JSON line, the card's name and power limit, and,
last, {"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.

Run from the repository root:  python3 chip_smoke.py [--profile]
(--profile also traces one transcribe_batch call, one engine pass and one
overlap pass with torch.profiler: kernel time by name and the card's busy
share.) On a host with N cards, python3 chip_smoke.py --cards N runs the
mesh over NCCL with one card a rank instead: entry.dryrun_multichip(N);
the model-sharded decode as CUDA graphs on small.en at full width at 1xN,
(N/2)x2 and 1x2 (greedy B = 8, 32, 128, beam 8 and 32 rows x 5, best_of 5
at t=0.1; graph against eager against 1x1, every rank's tokens and steps
equal, step ms, replays and peak memory per rank; the warm-up's decode
shapes led by rank 0 and followed by the others: one arena and the same
keys on every rank); the train CLI at (N/2)x2 under torchrun against 1x1;
and one served request with overlaps under torchrun on an (N/2)x2 mesh.
Without a CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

SR = 16000
WINDOW = 30 * SR
N_SEG = 8                      # segments in the main-path batch
# H100 SXM published peaks: HBM bytes/s, dense bf16 and TF32 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one ``fn()`` call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` captured once into a CUDA graph and
    replayed (``time_ms``): the kernels back to back, without the host's
    launch cost between them, as the decode graphs run them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, iters=iters, warmup=3)


def bound_ms(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def allclose(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float) -> bool:
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


# ------------------------------------------------------------------ phases

def sass_counts(lib_path) -> dict:
    """Tensor-core instructions in a built library's SASS: HGMMA (wgmma)
    and HMMA (mma.sync), by cuobjdump beside nvcc; {} without cuobjdump."""
    from clearconverse_tpu_torch.ops import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\.", sass)) for op in ("HGMMA", "HMMA")}


def phase_build():
    from clearconverse_tpu_torch.ops import build
    t0 = time.perf_counter()
    logs = build.build()
    secs = time.perf_counter() - t0
    sass = {}
    for name, (s, text) in logs.items():
        log(f"[build] {name}: {s:.1f} s")
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma")):
                log(f"[build]   {line.strip()}")
        sass[name] = sass_counts(build.library_path(name))
        log(f"[build]   SASS tensor-core instructions: "
            f"{sass[name] or 'cuobjdump not found'}")
    log(f"[build] all kernels in {secs:.1f} s")
    return secs, sass


def phase_kernels(gen: torch.Generator):
    """Each kernel against its plain version at the main path's shapes."""
    from clearconverse_tpu_torch.audio import mel as melmod
    from clearconverse_tpu_torch.ops import encoder_attention as k2
    from clearconverse_tpu_torch.ops import logmel as k1

    rows = []
    # K1 at [N_SEG, 30 s] and at the engine's batch of 32, f32, on noise and
    # on speech rows padded with silence (quiet bins near the clamp floor).
    # Bound: the least work the function needs. Bytes: the audio read, the
    # mel power written and the DFT and filterbank read once. Operations, at
    # the f32 rate: per frame the window (400 products), a real 400-point
    # FFT (2.5 N log2 N flops, half the usual 5 N log2 N of a complex one),
    # the power (3 flops a bin) and the slaney filterbank's nonzeros (2
    # flops each). Kept apart, for the record, in kernel_extra: 3 TF32
    # products per dense DFT and mel product (bound_dense_ms) and one f32
    # FMA per dense product (bound_f32_fma_ms).
    rng = np.random.default_rng(0)
    n_frames = WINDOW // 160
    frame_flops = (400 + 2.5 * 400 * math.log2(400) + 3 * 201
                   + 2 * int(np.count_nonzero(melmod.mel_filterbank(80))))
    k1_rows, k1_bounds = {}, {}
    # 1: the train CLI's data prep, per pair; 4: a data rank's rows of
    # phase 17's 2x1 mesh.
    for B in (1, N_SEG // 2, N_SEG, 32, 128):
        inputs = {
            "noise": torch.randn((B, WINDOW), generator=gen, device="cuda") * 0.1,
            "speech": torch.from_numpy(np.stack([
                np.pad(synth_speech(rng, s), (0, WINDOW - int(s * SR)))
                for s in np.linspace(5.0, 20.0, B)])).cuda()}
        errs = {}
        for label, audio in inputs.items():
            power = k1.mel_power(audio)
            power_ref = k1.mel_power_plain(audio)
            lm = melmod.log_mel_from_power(power)
            lm_ref = melmod.log_mel_spectrogram(audio)
            torch.cuda.synchronize()
            err = float((lm - lm_ref).abs().max())
            ok = allclose(power, power_ref, 2e-3, 1e-6) and err <= 5e-4
            log(f"[kernels] K1 mel_power {tuple(audio.shape)} f32 {label}: "
                f"log-mel max err {err:.3g} (atol 5e-4), power rtol 2e-3/"
                f"atol 1e-6 -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("K1 disagrees with its plain version")
            errs[label] = err
            del power, power_ref, lm, lm_ref
        audio = inputs["noise"]
        dense = B * n_frames * (2 * 2 * 400 * 201 + 2 * 201 * 80)
        moved = 4 * (audio.numel() + B * n_frames * 80
                     + 2 * 400 * 201 + 201 * 80)
        b_ms, b_by = bound_ms(moved, B * n_frames * frame_flops, "float32")
        k1_rows[B] = {
            "name": "mel_power", "route": "cuda",
            "source": "clearconverse_tpu_torch/csrc/logmel.cu",
            "replaces": "clearconverse_tpu/ops/pallas/logmel.py:57",
            "launches": 0, "max_abs_err": max(errs.values()),
            "ms": time_ms(lambda: k1.mel_power(audio)),
            "plain_ms": time_ms(lambda: k1.mel_power_plain(audio)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        k1_bounds[f"B={B}"] = {
            "bound_dense_ms": bound_ms(moved, 3 * dense, "tfloat32")[0],
            "bound_f32_fma_ms": bound_ms(moved, dense, "float32")[0]}
        del inputs, audio
    rows.append(k1_rows[N_SEG])
    extra = {f"mel_power_b{B}": {key: val for key, val in k1_rows[B].items()
                                 if key != "launches"}
             for B in (1, N_SEG // 2, 32, 128)}
    extra["mel_power_other_bounds"] = k1_bounds

    # K2 at T=1500, D=768, H=12: bf16 (the main path's dtype) at B=N_SEG, at
    # the engine's transcription batch of 32 and at the bench hot path's 128,
    # and f32 at B=N_SEG. The plain version runs 32 rows at a time (its f32
    # logits at B=128 would take 14 GB). q, k ~
    # N(0, 1) give logits of unit spread; v ~ 0.3 N(0, 1) as in
    # tests/test_pallas.py, so outputs stay below 0.25, where one bf16
    # rounding step of the output (both sides round it) is under 1e-3.
    T, D, H = 1500, 768, 12
    k2_rows = {}

    def k2_plain(q, k, v):
        return torch.cat([k2.encoder_attention_plain(
            q[i:i + 32], k[i:i + 32], v[i:i + 32], H)
            for i in range(0, q.shape[0], 32)])

    for B, dtype, atol in ((N_SEG, "float32", 1e-4), (N_SEG, "bfloat16", 2e-3),
                           (32, "bfloat16", 2e-3), (128, "bfloat16", 2e-3)):
        q, k, v = (torch.randn((B, T, D), generator=gen, device="cuda")
                   .mul_(scale).to(getattr(torch, dtype))
                   for scale in (1.0, 1.0, 0.3))
        out = k2.encoder_attention(q, k, v, H)
        ref = k2_plain(q, k, v)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        del out, ref
        log(f"[kernels] K2 encoder_attention {(B, T, D)} {dtype}: max err "
            f"{err:.3g} (atol {atol}) -> {'ok' if err <= atol else 'FAIL'}")
        if not err <= atol:
            raise SystemExit("K2 disagrees with its plain version")
        if dtype == "float32":
            extra["encoder_attention_f32_err"] = err
            extra["encoder_attention_f32_ms"] = time_ms(
                lambda: k2.encoder_attention(q, k, v, H), iters=3)
            continue
        qh, kh, vh = (x.view(B, T, H, 64).transpose(1, 2).contiguous()
                      for x in (q, k, v))
        b_ms, b_by = bound_ms(4 * q.numel() * 2, 4 * B * H * T * T * 64,
                              "bfloat16")
        k2_rows[B] = {
            "name": "encoder_attention", "route": "cuda",
            "source": "clearconverse_tpu_torch/csrc/encoder_attention.cu",
            "replaces": "clearconverse_tpu/ops/pallas/encoder_attention.py:61",
            "launches": 0, "max_abs_err": err,
            "ms": time_ms(lambda: k2.encoder_attention(q, k, v, H)),
            "plain_ms": time_ms(lambda: k2_plain(q, k, v), iters=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh))}
        del q, k, v, qh, kh, vh
    rows.append(k2_rows[N_SEG])
    for B in (32, 128):
        extra[f"encoder_attention_b{B}"] = {
            key: val for key, val in k2_rows[B].items() if key != "launches"}
    for label, r in [("", x) for x in rows] + [
            (f" (B={B})", r[B]) for B in (32, 128) for r in (k1_rows, k2_rows)]:
        log(f"[kernels] {r['name']}{label}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    log(f"[kernels] encoder_attention f32 {(N_SEG, T, D)}: "
        f"{extra['encoder_attention_f32_ms']:.4f} ms")
    extra["encoder_attention_mesh"] = k2_mesh_check(gen)
    extra["encoder_attention_train"] = k2_grad_check(gen)
    extra["separator"] = separator_kernels(gen)
    extra["voxtral_attention"] = voxtral_attention_kernel(gen)
    return rows, extra


# Voxtral's loop at the voxtral-mini-batch cell: 32 unique rows a decode
# call, best_of 5, max_tokens 128 + decode_graph.K suffix slots; phase 2
# and phase 22 take step 64, the loop's mean.
VX_ROWS, VX_REPLICAS, VX_SLOTS, VX_STEP = 32, 5, 136, 64
# Phase 22's limit on the widest log-probability gap between V1's step and
# the plain step over 160 rows x 131,072 ids: V1 read 0.031 and 0.033 nats
# on the H100 (the two round the softmax weights at different points).
VX_STEP_GAP = 0.3


def vx_prompt_positions() -> int:
    """The transcription prompt's positions at the published widths (387)."""
    from clearconverse_tpu_torch.models import voxtral as vx
    from clearconverse_tpu_torch.models.tokenizer import (
        TekkenByteTokenizer, TekkenSpecials)
    tok = TekkenByteTokenizer(TekkenSpecials())
    head, tail = tok.specials.prompt(tok.language_ids("en"))
    return len(head) + vx.VoxtralDims().audio_rows + len(tail)


def voxtral_attention_kernel(gen: torch.Generator):
    """V1 (ops/decode_attention.py) against its plain version at the cell's
    shape at step VX_STEP, on N(0, 1) q, k, v and caches, then kernel,
    plain and library ms, each replayed as a CUDA graph (``graph_ms``; the
    wrapper's checks on the host would otherwise set the pace), beside the
    bound: the bytes it must move (q, k, v and the output; the prefix K/V
    once; slots 0 .. step - 1 of every suffix; the slot written) at 3.35
    TB/s, or its two products at the bf16 tensor-core rate. Library: scaled_dot_product_attention over the prefix
    (the R replicas as R query positions, grouped heads) and over the
    suffix (one query a row, the slots copied out first), without RoPE, the
    slot write or the merge: a yardstick the port never calls."""
    from clearconverse_tpu_torch.models import voxtral as vx
    from clearconverse_tpu_torch.ops import decode_attention as da
    U, R, M, step = VX_ROWS, VX_REPLICAS, VX_SLOTS, VX_STEP
    P, H, D, G = vx_prompt_positions(), 8, 128, 4
    B = U * R

    def t(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    cos, sin = vx.rope_tables(vx.VoxtralDims(),
                              torch.tensor(P + step - 1, device="cuda"))
    q, k, v = t(B, G * H * D), t(B, H * D), t(B, H * D)
    prefix = {"k": t(U, H, P, D), "v": t(U, H, P, D)}
    suffix = {"k": t(U, H, R, M, D), "v": t(U, H, R, M, D)}
    st, kslot = torch.tensor(step, device="cuda"), torch.arange(M, device="cuda")

    def run(fn, suf):
        return fn(q, k, v, cos, sin, st, prefix, suf, kslot)

    plain_suf = {n: x.clone() for n, x in suffix.items()}
    got = run(da.decode_attention, suffix)
    want = run(da.decode_attention_plain, plain_suf)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    slot_ok = all(torch.equal(suffix[n], plain_suf[n]) for n in suffix)
    ok = err < 1.5e-2 and slot_ok
    log(f"[kernels] V1 decode_attention U={U} R={R} P={P} M={M} step={step}: "
        f"{err:.3g} of the largest output (limit 1.5e-2), slot bytes "
        f"{'equal' if slot_ok else 'DIFFER'} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("decode_attention disagrees with its plain version")
    moved = 2 * (2 * q.numel() + 2 * k.numel() + 2 * U * H * P * D
                 + 2 * U * H * R * step * D)
    flops = 4 * B * G * H * (P + step) * D
    b_ms, b_by = bound_ms(moved, flops, "bfloat16")
    qp = q.view(U, R, G * H, D).transpose(1, 2)             # [U, 32, R, D]
    qs = q.view(B, G * H, 1, D)
    ks, vs = (x[:, :, :, :step].permute(0, 2, 1, 3, 4).reshape(B, H, step, D)
              .contiguous() for x in (suffix["k"], suffix["v"]))

    def library():
        F.scaled_dot_product_attention(qp, prefix["k"], prefix["v"],
                                       enable_gqa=True)
        F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True)

    out = {"source": "clearconverse_tpu_torch/csrc/decode_attention.cu",
           "shape": {"U": U, "R": R, "P": P, "M": M, "step": step},
           "rel_err": err,
           "ms": graph_ms(lambda: run(da.decode_attention, suffix), 50),
           "plain_ms": graph_ms(lambda: run(da.decode_attention_plain,
                                            plain_suf)),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": graph_ms(library, 50)}
    log(f"[kernels] V1 decode_attention: kernel {out['ms']:.4f} ms, plain "
        f"{out['plain_ms']:.4f} ms, library (SDPA) {out['library_ms']:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{100 * b_ms / out['ms']:.1f}% of bound")
    return out


# The separator kernels' call shape in small.en-overlap: one separation
# call of 16 rows of 8.3 s (the cell's mean overlap span), 111 segments of
# 150 frames a row.
SEP_ROWS, SEP_SECONDS = 16, 8.3


def separator_kernels(gen: torch.Generator):
    """The published RE-SepFormer's two kernels (ops/sb_attention.py,
    ops/sb_ffn.py) against their plain versions at the overlap cell's call
    shape, on a seeded layer, then kernel and plain ms beside the bound:
    the attention's bytes at 3.35 TB/s or its multiply-adds at the float32
    FMA rate (67 TFLOP/s); the FFN's bytes or its products as three TF32
    products each at 495 TFLOP/s."""
    from clearconverse_tpu_torch.models import resepformer as rsf
    from clearconverse_tpu_torch.ops import sb_attention as sba
    from clearconverse_tpu_torch.ops import sb_ffn as sbf
    dims = rsf.ResepformerDims()
    model = rsf.init_resepformer(dims, seed=1, device="cuda")
    lyr = model.masknet.model.seg_model[0].mdl.layers[0]
    frames = (int(SEP_SECONDS * SR) - dims.enc_kernel) // dims.enc_stride + 1
    n_seg = SEP_ROWS * (frames // dims.segment_size + 1)
    T, D, H, Fh = dims.segment_size, dims.d_model, dims.n_heads, dims.d_ffn
    tokens = n_seg * T
    out = {"rows": SEP_ROWS, "seconds": SEP_SECONDS, "segments": n_seg}

    qkv = torch.randn((n_seg, T, 3 * D), generator=gen, device="cuda")
    got = sba.seg_attention(qkv, H)
    want = sba.seg_attention_plain(qkv, H)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = err <= 1e-5 * float(want.abs().max())
    log(f"[kernels] separator seg_attention {tuple(qkv.shape)}: max err "
        f"{err:.3g} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("seg_attention disagrees with its plain version")
    del got, want
    b_ms, b_by = bound_ms(4 * tokens * 4 * D, 4 * n_seg * T * T * D, "float32")
    out["seg_attention"] = {
        "source": "clearconverse_tpu_torch/csrc/sb_attention.cu",
        "max_abs_err": err, "ms": time_ms(lambda: sba.seg_attention(qkv, H)),
        "plain_ms": time_ms(lambda: sba.seg_attention_plain(qkv, H), iters=3),
        "bound_ms": b_ms, "bound_by": b_by}
    del qkv

    fc1, fc2 = lyr.pos_ffn.ffn[0], lyr.pos_ffn.ffn[3]
    p = (lyr.norm2.norm.weight, lyr.norm2.norm.bias, fc1.weight, fc1.bias,
         fc2.weight, fc2.bias)
    h = torch.randn((tokens, D), generator=gen, device="cuda")
    got = sbf.sb_ffn(h, *p)
    want = sbf.sb_ffn_plain(h, *p)
    torch.cuda.synchronize()
    err = float((got - want).norm() / (want - h).norm())
    ok = err <= 3e-6
    log(f"[kernels] separator sb_ffn {tuple(h.shape)}: error {err:.3g} of the "
        f"sublayer's norm (limit 3e-6) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("sb_ffn disagrees with its plain version")
    del got, want
    b_ms, b_by = bound_ms(4 * (2 * tokens * D + 4 * D * Fh),
                          3 * 4 * tokens * D * Fh, "tfloat32")
    out["sb_ffn"] = {
        "source": "clearconverse_tpu_torch/csrc/sb_ffn.cu",
        "rel_err": err, "ms": time_ms(lambda: sbf.sb_ffn(h, *p)),
        "plain_ms": time_ms(lambda: sbf.sb_ffn_plain(h, *p), iters=3),
        "bound_ms": b_ms, "bound_by": b_by}
    for name in ("seg_attention", "sb_ffn"):
        r = out[name]
        log(f"[kernels] separator {name} at {SEP_ROWS} rows of {SEP_SECONDS} s "
            f"({n_seg} segments): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    return out


# K2 at the shapes the mesh paths give it, each rank with its own heads:
# (B, T, heads, dtype, atol, where). Phase 17's 1x2 mesh (6 heads a rank,
# f32) and 2x1 mesh (4 rows a data rank); the same 6 heads in bf16, as a
# served 1x2 mesh of small.en runs them; dryrun_multichip's serving and
# engine model (2 heads, 128 wide) at 1x1 and its 1x2 shard (1 head, as
# also tests/test_torch_cuda.py's two ranks on one card).
K2_MESH_SHAPES = (
    (N_SEG, 1500, 6, "float32", 1e-4, "phase 17 1x2"),
    (N_SEG, 1500, 6, "bfloat16", 2e-3, "1x2 of small.en, bf16"),
    (N_SEG // 2, 1500, 12, "float32", 1e-4, "phase 17 2x1"),
    (4, 1500, 2, "float32", 1e-4, "dry run 1x1"),
    (4, 1500, 1, "float32", 1e-4, "dry run 1x2"),
)
# K2 through its autograd Function at the train steps' shapes:
# (B, T, heads, dtype, output atol, gradient limit of the largest, where).
# The train CLI's --batch 4 and its --accum_steps 2 microbatch at small.en;
# a sharded step's rank at model=2 of small.en (6 heads) and of tiny (3
# heads, the --cards run's train CLI at (N/2)x2 with 2 rows a data rank);
# dryrun_multichip's train step (2 of its 4 heads a rank, 32 frames, f32).
K2_GRAD_SHAPES = (
    (4, 1500, 12, "bfloat16", 2e-3, 3e-2, "train CLI"),
    (2, 1500, 12, "bfloat16", 2e-3, 3e-2, "train CLI microbatch"),
    (4, 1500, 6, "bfloat16", 2e-3, 3e-2, "small.en at model=2"),
    (2, 1500, 3, "bfloat16", 2e-3, 3e-2, "tiny at model=2"),
    (2, 32, 2, "float32", 1e-4, 1e-3, "dry run train step"),
)


def k2_mesh_check(gen: torch.Generator):
    """K2 against its plain version at K2_MESH_SHAPES (q, k ~ N(0, 1),
    v ~ 0.3 N(0, 1), as phase 2's main shapes)."""
    from clearconverse_tpu_torch.ops import encoder_attention as k2

    res = {}
    for B, T, H, dtype, atol, where in K2_MESH_SHAPES:
        q, k, v = (torch.randn((B, T, H * 64), generator=gen, device="cuda")
                   .mul_(scale).to(getattr(torch, dtype))
                   for scale in (1.0, 1.0, 0.3))
        out = k2.encoder_attention(q, k, v, H)
        ref = k2.encoder_attention_plain(q, k, v, H)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        log(f"[kernels] K2 encoder_attention {(B, T, H * 64)} {dtype}, "
            f"{H} heads ({where}): max err {err:.3g} (atol {atol}) -> "
            f"{'ok' if err <= atol else 'FAIL'}")
        if not err <= atol:
            raise SystemExit("K2 disagrees with its plain version at a "
                             "mesh shape")
        res[f"{(B, T, H * 64)} {dtype}"] = err
        del q, k, v, out, ref
    return res


def k2_grad_check(gen: torch.Generator):
    """K2 through its autograd Function at K2_GRAD_SHAPES: the output
    against the plain version, and the q, k, v gradients of a fixed
    cotangent against autograd through the plain version, within the
    given share of the largest gradient. The Function's backward
    recomputes through models/whisper.attention, which scales q and k by
    dh^-0.25 each where the plain version scales q by dh^-0.5: in bf16 on
    the CPU the two backwards differ by up to 8e-3 of the largest gradient
    at the train CLI's shapes."""
    from clearconverse_tpu_torch.ops import encoder_attention as k2

    res = {}
    for B, T, H, dtype, atol, limit, where in K2_GRAD_SHAPES:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn((B, T, H * 64), generator=gen, device="cuda")
                   .mul_(scale).to(dt) for scale in (1.0, 1.0, 0.3))
        g = torch.randn((B, T, H * 64), generator=gen, device="cuda").to(dt)
        outs, grads = {}, {}
        for label, fn in (("kernel", k2.encoder_attention),
                          ("plain", k2.encoder_attention_plain)):
            ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out = fn(*ins, H)
            if out.grad_fn is None:
                raise SystemExit(f"K2 {label} output at {where} has no "
                                 "grad_fn")
            grads[label] = torch.autograd.grad(out, ins, g)
            outs[label] = out.detach().float()
        torch.cuda.synchronize()
        err = float((outs["kernel"] - outs["plain"]).abs().max())
        grad_rel = {
            name: float((a.float() - b.float()).abs().max())
            / float(b.float().abs().max())
            for name, a, b in zip("qkv", grads["kernel"], grads["plain"])}
        finite = all(bool(torch.isfinite(a).all()) for a in grads["kernel"])
        ok = err <= atol and finite and max(grad_rel.values()) <= limit
        log(f"[kernels] K2 encoder_attention {(B, T, H * 64)} {dtype}, "
            f"{H} heads ({where}) with grad: output max err {err:.3g} (atol "
            f"{atol}), q/k/v gradient max err of the largest {grad_rel} "
            f"(limit {limit}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("K2's autograd Function disagrees with the "
                             f"plain version at {where}")
        res[f"{(B, T, H * 64)} {dtype}"] = {"max_abs_err": err,
                                            "grad_rel_err": grad_rel}
        del q, k, v, g, outs, grads
    torch.cuda.empty_cache()
    return res


def synth_speech(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """Voiced, syllable-modulated harmonic audio (a stand-in for speech)."""
    t = np.arange(int(seconds * SR)) / SR
    f0 = 110 + 40 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum(np.sin(h * phase) / h for h in range(1, 12))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3, 5) * t)) ** 2
    sig = voiced * env + 0.02 * rng.standard_normal(t.shape)
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def phase_slice():
    """2-layer small.en-width model, f32: the card (kernels) against the CPU
    (plain versions) on the same weights and audio."""
    from clearconverse_tpu_torch.audio.mel import log_mel_auto, pad_or_trim
    from clearconverse_tpu_torch.config import TorchConfig
    from clearconverse_tpu_torch.models import decoding
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.models.whisper import model_dims, whisper_encode
    from clearconverse_tpu_torch.ops import encoder_attention as k2
    from clearconverse_tpu_torch.ops import logmel as k1
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle

    dims = dataclasses.replace(model_dims("small.en"), n_audio_layer=2,
                               n_text_layer=2)
    cpu_model = init_whisper(dims, seed=1, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(1)
    audio = np.stack([np.pad(synth_speech(rng, s), (0, WINDOW - int(s * SR)))
                      for s in (7.0, 19.0)])
    cfg = TorchConfig(compute_dtype="float32", cross_kv_bits=16,
                      max_decode_tokens=16)
    res = {}
    outs = {}
    before = (k1.mel_power.launches, k2.encoder_attention.launches)
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        a = torch.from_numpy(audio).to(dev)
        mel = log_mel_auto(pad_or_trim(a, WINDOW), dims.n_mels)
        enc = whisper_encode(model, mel, dims, torch.float32)
        toks, lens = decoding.build_prompt_batch([[50257, 50362]] * 2, 4, 50256)
        toks_t, lens_t = (torch.from_numpy(x).to(dev) for x in (toks, lens))
        opts = decoding.DecodeOptions(max_tokens=16, suppress_tokens=tuple(
            range(50257, 51864)), no_speech_token=50361)
        prefill = decoding._prefill(model, mel, toks_t.long(), lens_t.long(),
                                    dims, opts, 4)[2]
        dec = decoding.greedy_decode_from_audio(model, a, toks_t, lens_t,
                                                dims, opts, 4)
        b = ModelBundle(torch_config=cfg, device=dev)
        b._whisper = (model, dims, ByteFallbackTokenizer())
        b._loaded = True
        texts = b.transcribe_batch(audio, ["", "a prompt"], temperature=0.0)
        outs[dev] = {"enc": enc.cpu(), "prefill": prefill.cpu(),
                     "tokens": dec["tokens"].cpu(), "texts": texts}
    launched = (k1.mel_power.launches - before[0],
                k2.encoder_attention.launches - before[1])
    enc_err = float((outs["cuda"]["enc"] - outs["cpu"]["enc"]).abs().max())
    lg_err = float((outs["cuda"]["prefill"] - outs["cpu"]["prefill"]).abs().max())
    same_tokens = torch.equal(outs["cuda"]["tokens"], outs["cpu"]["tokens"])
    same_texts = outs["cuda"]["texts"] == outs["cpu"]["texts"]
    res.update(encoder_max_err=enc_err, prefill_logits_max_err=lg_err,
               tokens_identical=same_tokens, texts_identical=same_texts,
               kernel_launches=launched)
    log(f"[slice] 2-layer d=768 f32, card vs CPU: encoder max err {enc_err:.3g} "
        f"(atol 2e-3), prefill logits max err {lg_err:.3g} (atol 5e-3), "
        f"tokens identical {same_tokens}, texts identical {same_texts}, "
        f"kernel launches on the card {launched}")
    if not (enc_err <= 2e-3 and lg_err <= 5e-3 and same_tokens and same_texts
            and min(launched) > 0):
        raise SystemExit("slice phase: card and CPU disagree")
    return res


def main_segments():
    """Phase 4's input: N_SEG voiced segments of 5–30 s with 0.5 s gaps,
    written to a WAV and read back. Returns (wave, starts, lens, the host
    batch of the 30 s bucket, audio seconds)."""
    from clearconverse_tpu_torch.audio.wav import read_wav, write_wav
    from clearconverse_tpu_torch.pipeline.batching import batch_audio

    rng = np.random.default_rng(2)
    durations = [5.0, 8.5, 12.0, 16.0, 20.0, 24.5, 28.0, 30.0][:N_SEG]
    gap = np.zeros(SR // 2, np.float32)
    pieces, starts, pos = [], [], 0
    for d in durations:
        seg = synth_speech(rng, d)
        starts.append(pos)
        pieces += [seg, gap]
        pos += len(seg) + len(gap)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "conversation.wav")
        write_wav(path, np.concatenate(pieces), SR)
        wave, sr = read_wav(path)
    assert sr == SR and wave.shape[0] == 1
    wave = wave[0]
    lens = [int(d * SR) for d in durations]
    segs = [wave[s:s + n] for s, n in zip(starts, lens)]
    (_, host_batch, _), = batch_audio(segs, SR, buckets=(30.0,), batch_size=N_SEG)
    return wave, starts, lens, host_batch, sum(durations)


def phase_main(profile: bool, model_dir: str):
    """small.en dims, default knobs, through the user's entry points;
    weights from ``model_dir``."""
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.models import decoding
    from clearconverse_tpu_torch.ops import encoder_attention as k2
    from clearconverse_tpu_torch.ops import logmel as k1
    from clearconverse_tpu_torch.pipeline.bundle import (
        ModelBundle, iter_store_batches)

    wave, starts, lens, host_batch, audio_s = main_segments()
    t0 = time.perf_counter()
    bundle = ModelBundle(Config(), TorchConfig(), model_dir=model_dir)
    if not bundle.load_with_progress():
        raise SystemExit("model load failed")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    model, dims, _ = bundle._whisper
    log(f"[main] weights {bundle.load_source['whisper']} at {dims}, "
        f"knobs {bundle.torch_config}, loaded in {load_s:.1f} s")
    store = bundle.make_store(wave[None], SR)
    (_, store_batch), = iter_store_batches(
        [(store, 0, s) for s in starts], lens, SR, (30.0,), N_SEG)

    decodes = []
    orig = decoding.greedy_decode

    def recorded(*args, **kw):
        out = orig(*args, **kw)
        decodes.append(out)
        return out

    decoding.greedy_decode = recorded
    calls = []
    k1.mel_power.launches = 0
    k2.encoder_attention.launches = 0
    try:
        for label, batch, temp in (("host t=0.1", host_batch, 0.1),
                                   ("store t=0.1", store_batch, 0.1),
                                   ("host t=0", host_batch, 0.0)):
            first = len(decodes)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            texts = bundle.transcribe_batch(batch, [""] * N_SEG,
                                            temperature=temp)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            outs = decodes[first:]
            if len(texts) != N_SEG or not all(isinstance(t, str) for t in texts):
                raise SystemExit(f"{label}: bad transcribe_batch result")
            for o in outs:
                if not (torch.isfinite(o["sum_logprob"]).all()
                        and ((o["no_speech_prob"] >= 0)
                             & (o["no_speech_prob"] <= 1)).all()):
                    raise SystemExit(f"{label}: non-finite decode output")
            call = {"call": label, "rows": N_SEG,
                    "decode_rows": int(outs[0]["tokens"].shape[0]),
                    "audio_s": audio_s, "wall_s": wall, "rtfx": audio_s / wall,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "decode_steps": [o["steps"] for o in outs],
                    "text_chars": [len(t) for t in texts]}
            calls.append(call)
            log(f"[main] {label}: rows {N_SEG} (decode rows "
                f"{call['decode_rows']}), audio {audio_s:.1f} s, wall "
                f"{wall:.3f} s, RTFx {call['rtfx']:.1f}, peak mem "
                f"{call['peak_mem_gb']:.2f} GB, decode steps "
                f"{call['decode_steps']}")
    finally:
        decoding.greedy_decode = orig
    launches = {"mel_power": k1.mel_power.launches,
                "encoder_attention": k2.encoder_attention.launches}
    log(f"[main] kernel launches on the main path: {launches}")
    if min(launches.values()) == 0:
        raise SystemExit("a kernel of the main path was never launched")

    breakdown = stage_breakdown(bundle, host_batch)
    if profile:
        breakdown["profile"] = profile_decode(bundle, host_batch,
                                              calls[1]["wall_s"])
    return calls, launches, breakdown


def stage_breakdown(bundle, host_batch):
    """Device time of each stage of one t=0.1 best_of=5 transcribe_batch
    call: the decode functions record their spans into the bundle's
    decode_timer, each span ended by a synchronize."""
    from clearconverse_tpu_torch.models import decoding
    from clearconverse_tpu_torch.utils.tracing import StageTimer

    steps = []
    orig = decoding.greedy_decode

    def recorded(*args, **kw):
        out = orig(*args, **kw)
        steps.append(out["steps"])
        return out

    timer = StageTimer(sync=True)
    bundle.decode_timer = timer
    decoding.greedy_decode = recorded
    try:
        t0 = time.perf_counter()
        bundle.transcribe_batch(host_batch, [""] * N_SEG, temperature=0.1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        decoding.greedy_decode = orig
        bundle.decode_timer = None
    spans = timer.as_dict()
    spans.update(whole_call=wall, steps=steps[0],
                 per_step_ms=spans["token_loop"] / max(steps[0] - 1, 1) * 1e3)
    log("[breakdown] " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in spans.items()))
    return spans


def profile_decode(bundle, host_batch, unprofiled_wall: float):
    """profile_call over one t=0.1 transcribe_batch call."""
    return profile_call(
        lambda: bundle.transcribe_batch(host_batch, [""] * N_SEG,
                                        temperature=0.1),
        unprofiled_wall, "profile")


def profile_call(fn, unprofiled_wall: float, tag: str):
    """CUDA kernel time by name and the device's busy share over one call of
    ``fn`` (torch.profiler). The share is given against the profiled wall
    time and against ``unprofiled_wall``, the same call's time without the
    profiler's host overhead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in kernels}
    busy = sum(dev_us.values()) / 1e6
    n_launch = sum(e.count for e in kernels)
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    log(f"[{tag}] kernels {n_launch}, device busy {busy:.4f} s; share "
        f"{100 * busy / wall:.1f}% of the profiled wall {wall:.3f} s, "
        f"{100 * busy / unprofiled_wall:.1f}% of the unprofiled "
        f"{unprofiled_wall:.3f} s")
    for name, us in top:
        log(f"[{tag}]   {us / 1e3:9.2f} ms  {name[:90]}")
    return {"profiled_wall_s": wall, "unprofiled_wall_s": unprofiled_wall,
            "device_busy_s": busy, "kernel_launches": n_launch,
            "top_ms": [(n, us / 1e3) for n, us in top]}


class _Errors(logging.Handler):
    """Collects the port's ERROR records during a phase."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _count_calls(bundle, name: str, counter: dict):
    orig = getattr(bundle, name)

    def counted(*args, **kw):
        counter[name] = counter.get(name, 0) + 1
        return orig(*args, **kw)
    setattr(bundle, name, counted)


def phase_engine(profile: bool, model_dir: str):
    """The engine's default pass at full width through process_files,
    weights from ``model_dir``; with ``profile``, one more pass under
    torch.profiler."""
    from clearconverse_tpu_torch.bench import engine_wavs
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.ops import encoder_attention as k2
    from clearconverse_tpu_torch.ops import logmel as k1
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

    errors = _Errors()
    port_log = logging.getLogger("clearconverse_tpu_torch")
    port_log.addHandler(errors)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            paths, file_s = engine_wavs(tmp, 8)
            audio_s = file_s * len(paths)
            t0 = time.perf_counter()
            tc = TorchConfig(diarization_onset=0.35, diarization_offset=0.25,
                             max_decode_tokens=64, max_fallback_attempts=1)
            eng = TranscriptionEngine(Config(noise_reduction_amount=0.2), tc,
                                      model_dir=model_dir,
                                      load_models_immediately=True)
            if not eng.models_are_loaded():
                raise SystemExit("engine: model load failed")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            log(f"[engine] weights {eng.models.load_source}, knobs {tc}, "
                f"loaded in {load_s:.1f} s")
            calls = {}
            for name in ("transcribe_batch", "transcribe_long_batch"):
                _count_calls(eng.models, name, calls)
            k1.mel_power.launches = 0
            k2.encoder_attention.launches = 0
            passes = []
            for label in ("cold", "timed 1", "timed 2"):
                calls.clear()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                results = eng.process_files(paths)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if any(r is None for r in results):
                    raise SystemExit(f"engine {label}: a file returned None")
                segs = [r["segments"] for r in results]
                longest = max(s.end - s.start for f in segs for s in f)
                if longest > 30.0 and not calls.get("transcribe_long_batch"):
                    raise SystemExit(f"engine {label}: a {longest:.1f} s "
                                     "segment decoded without "
                                     "transcribe_long_batch")
                for f in segs:
                    for s in f:
                        if not (isinstance(s.transcription, str)
                                and np.isfinite(s.audio).all()):
                            raise SystemExit(f"engine {label}: bad segment")
                p = {"pass": label, "audio_s": audio_s, "wall_s": wall,
                     "rtfx": audio_s / wall,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "segments_per_file": [len(f) for f in segs],
                     "longest_segment_s": longest, "calls": dict(calls),
                     "stage_times": dict(eng.last_run_stage_times),
                     "wire": dict(eng.last_run_wire)}
                passes.append(p)
                log(f"[engine] {label}: {len(paths)} files x {file_s:.0f} s, "
                    f"wall {wall:.3f} s, RTFx {p['rtfx']:.1f}, peak mem "
                    f"{p['peak_mem_gb']:.2f} GB, segments per file "
                    f"{p['segments_per_file']} (longest {longest:.2f} s), "
                    f"bundle calls {p['calls']}")
                split = ", ".join(f"{k} {v:.4f}" for k, v in
                                  sorted(p["stage_times"].items()))
                log(f"[engine]   stage split (s): {split}")
            wire = passes[-1]["wire"]
            log(f"[engine] wire {wire}")
            if (wire.get("format") != "int16"
                    or wire.get("rows_direct") != len(paths)):
                raise SystemExit(f"engine: the wire is {wire.get('format')} "
                                 f"with {wire.get('rows_direct')} rows read "
                                 f"into staging, not int16 with {len(paths)}")
            launches = {"mel_power": k1.mel_power.launches,
                        "encoder_attention": k2.encoder_attention.launches}
            log(f"[engine] kernel launches in the phase's three passes: "
                f"{launches}")
            if min(launches.values()) == 0:
                raise SystemExit("engine: a kernel was never launched")
            prof = (profile_call(lambda: eng.process_files(paths),
                                 passes[-1]["wall_s"], "engine profile")
                    if profile else None)
    finally:
        port_log.removeHandler(errors)
    if errors.records:
        raise SystemExit("engine: the port logged errors: " + "; ".join(
            r.getMessage() for r in errors.records[:5]))
    return {"load_s": load_s, "passes": passes, "launches": launches,
            "profile": prof}


def phase_engine_parity():
    """process_files on the card and on the CPU with the same seeded
    weights: full-width PyanNet and ECAPA, 2-layer small.en-width Whisper,
    f32, t=0."""
    from clearconverse_tpu_torch.audio.wav import write_wav
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.ecapa import EcapaDims, init_ecapa
    from clearconverse_tpu_torch.models.pyannet import PyannetDims, init_pyannet
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.models.whisper import model_dims
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        synth_conversation_speech)
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

    dims = dataclasses.replace(model_dims("small.en"), n_audio_layer=2,
                               n_text_layer=2)
    tc = TorchConfig(compute_dtype="float32", cross_kv_bits=16,
                     max_decode_tokens=32, diarization_onset=0.35,
                     diarization_offset=0.25)
    cpu_whisper = byte_text(init_whisper(dims, seed=1, device="cpu"))
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "conversation.wav")
        write_wav(path, synth_conversation_speech(), SR)
        for dev in ("cuda", "cpu"):
            b = ModelBundle(Config(temperature=0.0), tc, device=dev)
            b._whisper = (copy.deepcopy(cpu_whisper).to(dev), dims,
                          ByteFallbackTokenizer(english=True))
            b._ecapa, b._ecapa_dims = init_ecapa(EcapaDims(), 2, dev), EcapaDims()
            b._pyannet, b._pyannet_dims = (init_pyannet(PyannetDims(), 3, dev),
                                           PyannetDims())
            b._loaded = True
            embs = []
            for name in ("embed_batch", "embed_store", "embed_frames_store",
                         "embed_denoised_store", "embed_denoised_batch"):
                orig = getattr(b, name)

                def recorded(*a, _orig=orig, **kw):
                    out = _orig(*a, **kw)
                    embs.append(out[0] if isinstance(out, tuple) else out)
                    return out
                setattr(b, name, recorded)
            t0 = time.perf_counter()
            res, = TranscriptionEngine(Config(temperature=0.0), tc,
                                       models=b).process_files([path])
            wall = time.perf_counter() - t0
            if res is None:
                raise SystemExit(f"engine parity: the file returned None on {dev}")
            outs[dev] = ([(s.start, s.end, s.speaker_id, s.is_overlap,
                           s.transcription) for s in res["segments"]],
                         embs, wall)
    same = outs["cuda"][0] == outs["cpu"][0]
    n_emb = [len(outs[d][1]) for d in ("cuda", "cpu")]
    emb_err = (max(float(np.abs(a - c).max()) for a, c in
                   zip(outs["cuda"][1], outs["cpu"][1]))
               if n_emb[0] == n_emb[1] and n_emb[0] else float("inf"))
    log(f"[parity] 12 s file, card vs CPU: segments {len(outs['cuda'][0])}, "
        f"segments/labels/texts identical {same}, embedding calls {n_emb}, "
        f"max embedding err {emb_err:.3g} (atol 1e-4); wall card "
        f"{outs['cuda'][2]:.2f} s, CPU {outs['cpu'][2]:.2f} s")
    for seg in outs["cuda"][0]:
        log(f"[parity]   {seg[0]:.2f}-{seg[1]:.2f} {seg[2]} "
            f"overlap={seg[3]} text={seg[4][:60]!r}")
    if not (same and outs["cuda"][0] and emb_err <= 1e-4
            and any(seg[4] for seg in outs["cuda"][0])):
        raise SystemExit("engine parity: card and CPU disagree")
    return {"segments": outs["cuda"][0], "identical": same,
            "embedding_calls": n_emb, "max_embedding_err": emb_err}


def byte_text(model):
    """Every row of a random Whisper's token table but the 256 byte ids and
    EOT shrinks 100x, so the decode emits bytes the byte-fallback tokenizer
    renders as text, and the no-speech gate (which would blank it) stays
    shut. Returns the model."""
    with torch.no_grad():
        model.decoder.tok[256:50256] *= 0.01
        model.decoder.tok[50257:] *= 0.01
    return model


# Phase 7's pipeline settings. min_speakers=2: seeded ECAPA embeds the
# stationary tones by their onsets as much as by their bands, and only two
# forced clusters split the speakers (PERF.md §4).
OVERLAP_CONFIG = dict(noise_reduction_amount=0.2, min_speakers=2)


def overlap_engine(model_dir: str, device="cuda"):
    """Phase 7's engine: weights from ``model_dir`` where present, else
    seeded at full width; the crafted frequency-selective PyanNet at PyannetDims()
    unless a PyanNet checkpoint was loaded; a random Whisper gets byte_text
    so transcripts have text."""
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.models.pyannet import PyannetDims
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        craft_pyannet_freq_params)
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

    tc = TorchConfig(diarization_onset=0.35, diarization_offset=0.25,
                     max_decode_tokens=64, max_fallback_attempts=1)
    eng = TranscriptionEngine(Config(**OVERLAP_CONFIG), tc,
                              model_dir=model_dir, device=device,
                              load_models_immediately=True)
    if not eng.models_are_loaded():
        raise SystemExit("overlap: model load failed")
    b = eng.models
    if b.load_source["pyannet"] == "random_init":
        b._pyannet, b._pyannet_dims = craft_pyannet_freq_params(
            PyannetDims(), device=device)
        b.load_source["pyannet"] = "crafted"
    if b.load_source["whisper"] == "random_init":
        byte_text(b._whisper[0])
    return eng


def check_words(words, label: str) -> int:
    """0 <= start <= end <= 30 for every word, starts in order per row;
    returns the word count."""
    for row in words:
        starts = [w["start"] for w in row]
        if starts != sorted(starts) or not all(
                0.0 <= w["start"] <= w["end"] <= 30.0 for w in row):
            raise SystemExit(f"{label}: word times out of order or range: "
                             f"{row[:5]}")
    return sum(len(r) for r in words)


def separation_split(model, rows: int):
    """Device time of one sepformer_separate call on ``rows`` rows of 5 s
    (the engine's separation batch) against its intra-chunk attention
    (softmax(QKᵀ)V of one layer at the call's shapes, times the intra
    layers), and the call's own peak memory, by CUDA events."""
    from clearconverse_tpu_torch.models import resepformer as rsf
    from clearconverse_tpu_torch.utils.precision import full_f32
    dims = model.dims
    gen = torch.Generator(device="cuda").manual_seed(7)
    mix = torch.randn((rows, 5 * SR), generator=gen, device="cuda") * 0.1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    call_ms = time_ms(lambda: rsf.sepformer_separate(model, mix), iters=3,
                      warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    frames = (5 * SR - dims.enc_kernel) // dims.enc_stride + 1
    chunks, _ = rsf._chunk(torch.zeros((1, frames, 1), device="cuda"),
                           dims.chunk_size)
    n_seq = rows * chunks.shape[1]
    dh = dims.d_model // dims.n_heads
    q, k, v = (torch.randn((n_seq, dims.n_heads, dims.chunk_size, dh),
                           generator=gen, device="cuda") for _ in range(3))
    x = torch.randn((n_seq, dims.chunk_size, dims.d_model), generator=gen,
                    device="cuda")
    layer = model.masknet.repeats[0].intra[0]
    with full_f32():
        attn_ms = time_ms(lambda: torch.matmul(torch.softmax(
            torch.matmul(q * dh ** -0.5, k.transpose(-1, -2)), dim=-1), v),
            iters=5)
        layer_ms = time_ms(lambda: rsf._tf_forward(x, [layer], dims.n_heads),
                           iters=5)
    n_intra = dims.n_repeats * dims.n_intra_layers
    out = {"rows": rows, "call_ms": call_ms, "peak_mem_gb": peak_gb,
           "intra_sequences": n_seq, "attention_core_ms": attn_ms,
           "intra_layer_ms": layer_ms,
           "intra_attention_share": n_intra * attn_ms / call_ms,
           "intra_layers_share": n_intra * layer_ms / call_ms}
    log(f"[overlap] one separation call, {rows} x 5 s: {call_ms:.2f} ms, peak "
        f"{peak_gb:.2f} GB; {n_seq} intra sequences of {dims.chunk_size}: "
        f"attention core {attn_ms:.2f} ms a layer, whole intra layer "
        f"{layer_ms:.2f} ms; {n_intra} intra layers = "
        f"{100 * out['intra_attention_share']:.1f} % (attention core) / "
        f"{100 * out['intra_layers_share']:.1f} % (layers) of the call")
    return out


def published_separation(b):
    """One separate_batch call through ``b`` with the published
    RE-SepFormer (seeded) in the sketch's place, SEP_ROWS rows of mixed
    lengths up to SEP_SECONDS: its time and the layers that ran the two
    separator kernels, which must be 16 (attention: every segment-block
    layer) and 24 (FFN: every layer of the three blocks)."""
    from clearconverse_tpu_torch.models import resepformer as rsf
    sketch = b._sepformer
    b._sepformer = rsf.init_resepformer(rsf.ResepformerDims(), seed=1,
                                        device="cuda")
    rsf.prepare_kernels(b._sepformer)
    try:
        rng = np.random.default_rng(3)
        T = int(SEP_SECONDS * SR)
        lens = np.linspace(0.15, 1.0, SEP_ROWS) * T
        lens = lens.astype(np.int64)
        mix = (0.3 * rng.standard_normal((SEP_ROWS, T))).astype(np.float32)
        mix[np.arange(T)[None, :] >= lens[:, None]] = 0.0
        b.separate_batch(mix, lens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.separate_batch(mix, lens)
        wall_ms = (time.perf_counter() - t0) * 1e3
        ran = dict(b.last_separation)
    finally:
        b._sepformer = sketch
    log(f"[overlap] published RE-SepFormer, one separate_batch of "
        f"{SEP_ROWS} rows up to {SEP_SECONDS} s: {wall_ms:.1f} ms, "
        f"fused_attn_layers {ran['fused_attn_layers']}, fused_ffn_layers "
        f"{ran['fused_ffn_layers']}")
    if (ran["fused_attn_layers"], ran["fused_ffn_layers"]) != (16, 24):
        raise SystemExit(f"published separator: kernel layers {ran}")
    return {"wall_ms": wall_ms, **ran}


def phase_overlap(profile: bool, model_dir: str):
    """The overlap path at full width through process_files, weights from
    ``model_dir``; then one word-timestamp transcription call. Returns
    (report, engine)."""
    from clearconverse_tpu_torch.audio.wav import read_wav
    from clearconverse_tpu_torch.bench import overlap_wavs
    from clearconverse_tpu_torch.ops import encoder_attention as k2
    from clearconverse_tpu_torch.ops import logmel as k1
    from clearconverse_tpu_torch.pipeline.bundle import _row_bucket

    errors = _Errors()
    port_log = logging.getLogger("clearconverse_tpu_torch")
    port_log.addHandler(errors)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # Scaled 1 % apart, so no two files are the same.
            paths, file_s = overlap_wavs(tmp, 8)
            audio_s = file_s * len(paths)
            t0 = time.perf_counter()
            eng = overlap_engine(model_dir)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            b = eng.models
            log(f"[overlap] weights {b.load_source}, sepformer "
                f"{b._sepformer.dims}, config {OVERLAP_CONFIG}, knobs "
                f"{eng.torch_config}, loaded in {load_s:.1f} s")
            calls, sep_rows, peaks = {}, [], {"pass": 0, "separation": 0}
            for name in ("transcribe_batch", "transcribe_long_batch"):
                _count_calls(b, name, calls)
            separate = b.separate_batch

            def counted_separate(audio, lengths=None):
                """Counts the call and its rows, and takes its own peak
                device memory (the pass's peak so far is kept first)."""
                calls["separate_batch"] = calls.get("separate_batch", 0) + 1
                sep_rows.append((len(audio), _row_bucket(len(audio)),
                                 int(np.shape(audio)[1])))
                peaks["pass"] = max(peaks["pass"],
                                    torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
                out = separate(audio, lengths)
                peaks["separation"] = max(peaks["separation"],
                                          torch.cuda.max_memory_allocated())
                return out
            b.separate_batch = counted_separate
            k1.mel_power.launches = 0
            k2.encoder_attention.launches = 0
            passes = []
            for label in ("cold", "timed 1", "timed 2"):
                calls.clear()
                sep_rows.clear()
                peaks.update({"pass": 0, "separation": 0})
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                results = eng.process_files(paths)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                peak = max(peaks["pass"], torch.cuda.max_memory_allocated())
                if any(r is None for r in results):
                    raise SystemExit(f"overlap {label}: a file returned None")
                segs = [r["segments"] for r in results]
                overlaps = [sum(s.is_overlap for s in f) for f in segs]
                if min(overlaps) == 0:
                    raise SystemExit(f"overlap {label}: a file has no overlap "
                                     f"segment: {overlaps}")
                if not calls.get("separate_batch"):
                    raise SystemExit(f"overlap {label}: separate_batch never ran")
                for f in segs:
                    for seg in f:
                        if not (isinstance(seg.transcription, str)
                                and np.isfinite(seg.audio).all()):
                            raise SystemExit(f"overlap {label}: bad segment")
                p = {"pass": label, "audio_s": audio_s, "wall_s": wall,
                     "rtfx": audio_s / wall, "peak_mem_gb": peak / 1e9,
                     "separation_peak_mem_gb": peaks["separation"] / 1e9,
                     "segments_per_file": [len(f) for f in segs],
                     "overlap_segments_per_file": overlaps,
                     "separation_rows": list(sep_rows),
                     "calls": dict(calls),
                     "overlap_path": dict(eng.last_run_separation),
                     "stage_times": dict(eng.last_run_stage_times),
                     "text_chars": sum(len(seg.transcription)
                                       for f in segs for seg in f)}
                passes.append(p)
                log(f"[overlap] {label}: {len(paths)} files x {file_s:.0f} s, "
                    f"wall {wall:.3f} s, RTFx {p['rtfx']:.1f}, peak mem "
                    f"{p['peak_mem_gb']:.2f} GB (separation calls "
                    f"{p['separation_peak_mem_gb']:.2f} GB), segments per file "
                    f"{p['segments_per_file']}, overlap segments "
                    f"{overlaps}, separation (rows, padded rows, samples) "
                    f"per call {p['separation_rows']}, bundle calls "
                    f"{p['calls']}, transcript chars {p['text_chars']}")
                ov = p["overlap_path"]
                log(f"[overlap]   overlap path: separation calls "
                    f"{ov['calls']}, real rows a call "
                    f"{ov['real_rows'] / max(ov['calls'], 1):.2f}, "
                    f"reseg_calls {ov['reseg_calls']}, source_calls "
                    f"{ov['source_calls']}, fused_attn_layers "
                    f"{ov['fused_attn_layers']}, fused_ffn_layers "
                    f"{ov['fused_ffn_layers']}")
                split = ", ".join(f"{k} {v:.4f}" for k, v in
                                  sorted(p["stage_times"].items()))
                log(f"[overlap]   stage split (s): {split}")
            launches = {"mel_power": k1.mel_power.launches,
                        "encoder_attention": k2.encoder_attention.launches}
            log(f"[overlap] kernel launches in the phase's three passes: "
                f"{launches}")
            if min(launches.values()) == 0:
                raise SystemExit("overlap: a kernel was never launched")
            prof = (profile_call(lambda: eng.process_files(paths),
                                 passes[-1]["wall_s"], "overlap profile")
                    if profile else None)
            sep_split = separation_split(b._sepformer,
                                         passes[-1]["separation_rows"][0][1])
            published = published_separation(b)

            # One word-timestamp call at full width: 8 rows of 6 s.
            wave = read_wav(paths[0])[0][0]
            rows = np.stack([wave[i * 6 * SR:(i + 1) * 6 * SR]
                             for i in range(8)]).astype(np.float32)
            k1.mel_power.launches = 0
            k2.encoder_attention.launches = 0
            t0 = time.perf_counter()
            texts, words = b.transcribe_batch(rows, ["a conversation"] * 8,
                                              temperature=0.0,
                                              word_timestamps=True)
            torch.cuda.synchronize()
            align_wall = time.perf_counter() - t0
            align_launches = {"mel_power": k1.mel_power.launches,
                              "encoder_attention":
                                  k2.encoder_attention.launches}
            n_words = check_words(words, "overlap word timestamps")
            log(f"[overlap] transcribe_batch(word_timestamps=True) on 8 x 6 s: "
                f"{align_wall:.3f} s, words per row {[len(w) for w in words]}, "
                f"first {words[0][:3]}, kernel launches {align_launches}")
            if len(words) != 8 or (n_words == 0 and
                                   b.load_source["whisper"] == "random_init"):
                raise SystemExit("overlap: the word-timestamp call gave no words")
            if min(align_launches.values()) == 0:
                raise SystemExit("overlap: the alignment pass launched no kernel")
    finally:
        port_log.removeHandler(errors)
    if errors.records:
        raise SystemExit("overlap: the port logged errors: " + "; ".join(
            r.getMessage() for r in errors.records[:5]))
    b.separate_batch = separate
    return ({"load_s": load_s, "passes": passes, "launches": launches,
             "profile": prof, "separation_split": sep_split,
             "published_separation": published,
             "align": {"wall_s": align_wall,
                                        "words_per_row": [len(w) for w in words],
                                        "launches": align_launches}}, eng)


def sep_mixtures(rows: int = 3, seconds: int = 5) -> np.ndarray:
    """Seeded two-tone mixtures with a little noise; the last row is silent
    after 3 s."""
    rng = np.random.default_rng(13)
    t = np.arange(seconds * SR) / SR
    tones = ((300, 2000), (180, 900), (250, 1500), (400, 1200))[:rows]
    mix = np.stack([0.4 * np.sin(2 * np.pi * f0 * t)
                    + 0.3 * np.sin(2 * np.pi * f1 * t)
                    + 0.02 * rng.standard_normal(t.size) for f0, f1 in tones])
    mix[-1, 3 * SR:] = 0.0
    return mix.astype(np.float32)


def phase_overlap_parity(devices=("cuda", "cpu")):
    """separate_batch, process_files with overlaps and word timestamps on
    the card and on the CPU with the same seeded weights."""
    from clearconverse_tpu_torch.bench import overlap_wavs
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.ecapa import EcapaDims, init_ecapa
    from clearconverse_tpu_torch.models.pyannet import PyannetDims
    from clearconverse_tpu_torch.models.resepformer import (
        SepformerDims, init_sepformer)
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.models.whisper import model_dims
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        craft_pyannet_freq_params)
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

    mix = sep_mixtures()
    dims = dataclasses.replace(model_dims("small.en"), n_audio_layer=2,
                               n_text_layer=2)
    cpu_whisper = byte_text(init_whisper(dims, seed=1, device="cpu"))
    cfg = Config(temperature=0.0, min_speakers=2)
    tc = TorchConfig(compute_dtype="float32", cross_kv_bits=16,
                     max_decode_tokens=32, diarization_onset=0.35,
                     diarization_offset=0.25)
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        (path,), _ = overlap_wavs(tmp, 1, tiles=2)
        for dev in devices:
            b = ModelBundle(cfg, tc, device=dev)
            b._whisper = (copy.deepcopy(cpu_whisper).to(dev), dims,
                          ByteFallbackTokenizer(english=True))
            b._ecapa, b._ecapa_dims = init_ecapa(EcapaDims(), 2, dev), EcapaDims()
            b._pyannet, b._pyannet_dims = craft_pyannet_freq_params(
                PyannetDims(), device=dev)
            b._sepformer = init_sepformer(SepformerDims(), seed=1, device=dev)
            b._loaded = True
            t0 = time.perf_counter()
            sep = b.separate_batch(mix)
            sep_wall = time.perf_counter() - t0
            n_sep = [0]
            separate = b.separate_batch

            def counted(audio, lengths=None, _f=separate):
                n_sep[0] += 1
                return _f(audio, lengths)
            b.separate_batch = counted
            t0 = time.perf_counter()
            res, = TranscriptionEngine(cfg, tc, models=b).process_files([path])
            wall = time.perf_counter() - t0
            if res is None:
                raise SystemExit(f"overlap parity: the file returned None on {dev}")
            rows = np.stack([np.tile(mix[0], 2)[: 8 * SR],
                             np.tile(mix[1], 2)[: 8 * SR]])
            texts, words = b.transcribe_batch(rows, ["a prompt", "more words"],
                                              temperature=0.0,
                                              word_timestamps=True)
            outs[dev] = {"sep": sep, "sep_wall": sep_wall, "wall": wall,
                         "calls": n_sep[0],
                         "segments": [(s.start, s.end, s.speaker_id,
                                       s.is_overlap, s.transcription)
                                      for s in res["segments"]],
                         "texts": texts, "words": words}
    card, cpu = outs[devices[0]], outs[devices[1]]
    sep_err = float(np.abs(card["sep"] - cpu["sep"]).max())
    sep_ok = bool(np.all(np.abs(card["sep"] - cpu["sep"])
                         <= 1e-4 + 1e-3 * np.abs(cpu["sep"])))
    same = card["segments"] == cpu["segments"]
    n_overlap = sum(seg[3] for seg in card["segments"])
    same_words = ([[w["word"] for w in r] for r in card["words"]]
                  == [[w["word"] for w in r] for r in cpu["words"]])
    dt = max((max(abs(a["start"] - c["start"]), abs(a["end"] - c["end"]))
              for ra, rc in zip(card["words"], cpu["words"])
              for a, c in zip(ra, rc)), default=0.0)
    n_words = check_words(card["words"], "overlap parity")
    log(f"[overlap parity] separate_batch {mix.shape} at SepformerDims(): max "
        f"err {sep_err:.3g} (rtol 1e-3 / atol 1e-4) -> "
        f"{'ok' if sep_ok else 'FAIL'}; one call {card['sep_wall']:.3f} s on "
        f"the card (cold), {cpu['sep_wall']:.3f} s on the CPU")
    log(f"[overlap parity] 24 s file: segments {len(card['segments'])}, "
        f"overlap segments {n_overlap}, separate_batch calls "
        f"{card['calls']}/{cpu['calls']}, segments/flags/labels/texts "
        f"identical {same}; wall card {card['wall']:.2f} s, CPU "
        f"{cpu['wall']:.2f} s")
    for seg in card["segments"]:
        log(f"[overlap parity]   {seg[0]:.2f}-{seg[1]:.2f} {seg[2]} "
            f"overlap={seg[3]} text={seg[4][:40]!r}")
    log(f"[overlap parity] word timestamps: words {n_words}, identical "
        f"{same_words}, max time difference {dt:.3g} s (<= 0.02), texts "
        f"identical {card['texts'] == cpu['texts']}")
    if not (sep_ok and same and n_overlap and card["calls"] and same_words
            and dt <= 0.02 + 1e-9 and n_words
            and card["texts"] == cpu["texts"]):
        raise SystemExit("overlap parity: card and CPU disagree")
    return {"sep_max_err": sep_err, "segments": card["segments"],
            "identical": same, "overlap_segments": int(n_overlap),
            "words": n_words, "max_word_time_diff_s": dt,
            "sep_wall_s": {d: outs[d]["sep_wall"] for d in devices}}


def _http(port: int, method: str, path: str, body: bytes = b"",
          headers=None, timeout: float = 600.0):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _ws_progress(port: int, task_id: str, timeout: float = 600.0):
    """Every JSON message of /ws/progress/{task_id} up to progress 100."""
    import base64
    import socket
    import struct
    sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        key = base64.b64encode(os.urandom(16)).decode()
        sock.sendall((f"GET /ws/progress/{task_id} HTTP/1.1\r\nHost: localhost"
                      f"\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                      f"Sec-WebSocket-Key: {key}\r\n"
                      f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += sock.recv(4096)
        head, _, buf = buf.partition(b"\r\n\r\n")
        if b" 101 " not in head.split(b"\r\n")[0]:
            raise SystemExit(f"serve: websocket upgrade refused: {head[:80]!r}")
        msgs = []
        deadline = time.time() + timeout
        while time.time() < deadline:
            while len(buf) < 2:
                buf += sock.recv(4096)
            op, n, off = buf[0] & 0x0F, buf[1] & 0x7F, 2
            if n == 126:
                while len(buf) < 4:
                    buf += sock.recv(4096)
                n, off = struct.unpack(">H", buf[2:4])[0], 4
            while len(buf) < off + n:
                buf += sock.recv(4096)
            payload, buf = buf[off:off + n], buf[off + n:]
            if op == 0x1:
                msgs.append(json.loads(payload))
                if msgs[-1].get("progress") == 100:
                    return msgs
            elif op == 0x8:
                break
        raise SystemExit(f"serve: websocket ended without progress 100: {msgs}")
    finally:
        sock.close()


def phase_serve(eng):
    """The port's app on 127.0.0.1 in front of phase 7's engine: one upload
    with overlaps through the user's routes."""
    import asyncio
    import socket
    import threading
    from clearconverse_tpu_torch.bench import overlap_wavs
    from clearconverse_tpu_torch.ops import encoder_attention as k2
    from clearconverse_tpu_torch.ops import logmel as k1
    from clearconverse_tpu_torch.serve.app import create_app

    errors = _Errors()
    port_log = logging.getLogger("clearconverse_tpu_torch")
    port_log.addHandler(errors)
    loop = asyncio.new_event_loop()
    stop = threading.Event()

    async def run_server(app, port):
        task = asyncio.ensure_future(app.serve("127.0.0.1", port))
        while not stop.is_set() and not task.done():
            await asyncio.sleep(0.05)
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass

    thread = None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            app = create_app(os.path.join(tmp, "processed"),
                             os.path.join(tmp, "uploads"), lambda: eng,
                             start_cleanup=False)
            sock = socket.socket()
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
            sock.close()
            thread = threading.Thread(
                target=loop.run_until_complete, args=(run_server(app, port),),
                daemon=True)
            thread.start()
            for _ in range(200):
                try:
                    if _http(port, "GET", "/health", timeout=5)[0] == 200:
                        break
                except OSError:
                    time.sleep(0.05)
            (wav,), _ = overlap_wavs(tmp, 1, tiles=2)
            with open(wav, "rb") as fh:
                data = fh.read()
            boundary = "ccsmokeboundary"
            body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                    f"name=\"file\"; filename=\"meeting.wav\"\r\n"
                    f"Content-Type: audio/wav\r\n\r\n").encode() + data + \
                f"\r\n--{boundary}--\r\n".encode()
            steps = []

            def call(method, path, body=b"", headers=None):
                status, payload, hdrs = _http(port, method, path, body, headers)
                steps.append((method, path.split("/")[1], status))
                if status != 200:
                    raise SystemExit(f"serve: {method} {path} -> {status}: "
                                     f"{payload[:200]!r}")
                return payload, hdrs

            t0 = time.perf_counter()
            up = json.loads(call("POST", "/upload-file", body, {
                "Content-Type": f"multipart/form-data; boundary={boundary}"})[0])
            tid = up["task_id"]
            k1.mel_power.launches = 0
            k2.encoder_attention.launches = 0
            call("POST", f"/transcribe/{tid}")
            msgs = _ws_progress(port, tid)
            launches = {"mel_power": k1.mel_power.launches,
                        "encoder_attention": k2.encoder_attention.launches}
            request_s = time.perf_counter() - t0
            status = json.loads(call("GET", f"/task/{tid}/status")[0])
            text = json.loads(call("GET", f"/transcription/{tid}")[0])
            pdf, hdrs = call("GET", f"/download-pdf/{tid}")
            transcript = text.get("transcription", "")
            log(f"[serve] upload {len(data)} bytes, transcribe, websocket "
                f"({len(msgs)} messages, last {msgs[-1]}), status "
                f"{status.get('status')}; request {request_s:.2f} s; "
                f"transcript {transcript.count('[SPEAKER_')} speaker lines; "
                f"PDF {len(pdf)} bytes ({hdrs.get('Content-Disposition')}); "
                f"kernel launches {launches}")
            for line in transcript.splitlines()[:8]:
                log(f"[serve]   {line[:70]}")
            if (status.get("status") != "completed"
                    or "error" in msgs[-1]["message"].lower()
                    or "[SPEAKER_" not in transcript
                    or not pdf.startswith(b"%PDF")):
                raise SystemExit("serve: the request did not complete with a "
                                 "transcript")
            if min(launches.values()) == 0:
                raise SystemExit("serve: a kernel was never launched")
    finally:
        stop.set()
        if thread is not None:
            thread.join(timeout=30)
        loop.close()
        port_log.removeHandler(errors)
    if errors.records:
        raise SystemExit("serve: the port logged errors: " + "; ".join(
            r.getMessage() for r in errors.records[:5]))
    return {"steps": steps, "ws_messages": msgs, "request_s": request_s,
            "launches": launches,
            "speaker_lines": transcript.count("[SPEAKER_")}


# ------------------------------------------ checkpoints, int4, bench, parity

ALL_CHECKPOINT = {"whisper": "checkpoint", "tokenizer": "BPETokenizer",
                  "ecapa": "checkpoint", "pyannet": "checkpoint",
                  "sepformer": "checkpoint"}


# The keys of bench._measured's launch counts, by kernel.
BENCH_KEY = {"mel_power": "k1", "encoder_attention": "k2"}


def phase_rehearsal(model_dir: str):
    """The dress-rehearsal checkpoint set at full scale into ``model_dir``,
    a cold ModelBundle on it with the default knobs, and one transcribe_batch
    on phase 4's segments. Returns (report, bundle, host batch)."""
    from clearconverse_tpu_torch.bench import _measured
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.eval import dress_rehearsal as dr
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.whisper import model_dims
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle

    t0 = time.perf_counter()
    paths = dr.populate(model_dir, "small.en", seed=0, device="cuda")
    write_s = time.perf_counter() - t0
    sizes_mb = {fam: dr.path_bytes(p) / 1e6 for fam, p in paths.items()}
    with open(paths["tokenizer"], encoding="utf-8") as fh:
        n_vocab = len(json.load(fh))
    log(f"[rehearsal] populate(small.en, EcapaDims(), PyannetDims(), "
        f"SepformerDims(), 50,000 merges) in {write_s:.1f} s; MB "
        f"{ {k: round(v, 1) for k, v in sizes_mb.items()} }; vocab {n_vocab}")

    t0 = time.perf_counter()
    bundle = ModelBundle(Config(), TorchConfig(), model_dir=model_dir)
    if not bundle.load_with_progress():
        raise SystemExit("rehearsal: model load failed")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    model, dims, tok = bundle._whisper
    # The loaded weights against the written module rounded to fp16 (the
    # file's precision) and then to the dtype they were loaded in.
    got = dict(model.named_parameters())
    reload_err = 0.0
    for name, p in init_whisper(model_dims("small.en"), 0, "cuda").named_parameters():
        want = p.detach().half().to(got[name].dtype)
        reload_err = max(reload_err,
                         float((got[name].float() - want.float()).abs().max()))
    torch.cuda.empty_cache()
    log(f"[rehearsal] cold ModelBundle in {load_s:.1f} s: load_source "
        f"{bundle.load_source}, dims {dims}, tokenizer merges {len(tok.ranks)}; "
        f"reloaded Whisper vs the written module rounded to fp16: max err "
        f"{reload_err}")
    if (bundle.load_source != ALL_CHECKPOINT or dims != model_dims("small.en")
            or reload_err != 0.0 or n_vocab != 50257
            or len(tok.ranks) != 50000):
        raise SystemExit("rehearsal: the checkpoint set did not load as written")

    _, _, _, host_batch, audio_s = main_segments()
    counted: dict = {}
    with _measured(torch.device("cuda"), counted):
        t0 = time.perf_counter()
        texts = bundle.transcribe_batch(host_batch, [""] * N_SEG,
                                        temperature=Config().temperature)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = counted["launches"]
    log(f"[rehearsal] transcribe_batch at the default knobs on phase 4's "
        f"{N_SEG} segments: {wall:.3f} s (RTFx {audio_s / wall:.1f}), text "
        f"chars {[len(t) for t in texts]}, kernel launches {launches}")
    if len(texts) != N_SEG or not all(isinstance(t, str) for t in texts):
        raise SystemExit("rehearsal: bad transcribe_batch result")
    if min(launches.values()) == 0:
        raise SystemExit("rehearsal: a kernel was never launched")
    return ({"write_s": write_s, "load_s": load_s, "sizes_mb": sizes_mb,
             "vocab": n_vocab, "reload_max_err": reload_err,
             "load_source": dict(bundle.load_source),
             "transcribe_wall_s": wall, "launches": launches},
            bundle, host_batch)


def phase_int4(bundle, host_batch):
    """int4 cross-KV: a 2-layer small.en-width model at f32 t=0, card vs CPU
    (identical tokens and texts); then phase 4's full-width call on the
    rehearsal bundle at int8 and at int4: decode step time, peak memory and
    the cross-KV bytes at rest."""
    from clearconverse_tpu_torch.audio.mel import log_mel_auto, pad_or_trim
    from clearconverse_tpu_torch.bench import _measured
    from clearconverse_tpu_torch.config import TorchConfig
    from clearconverse_tpu_torch.models import decoding
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.models.whisper import (
        model_dims, precompute_cross_kv, whisper_encode)
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    from clearconverse_tpu_torch.utils.tracing import StageTimer

    dims = dataclasses.replace(model_dims("small.en"), n_audio_layer=2,
                               n_text_layer=2)
    cpu_model = init_whisper(dims, seed=1, device="cpu")
    rng = np.random.default_rng(4)
    audio = np.stack([np.pad(synth_speech(rng, s), (0, WINDOW - int(s * SR)))
                      for s in (9.0, 23.0)])
    toks, lens = decoding.build_prompt_batch([[50257, 50362]] * 2, 4, 50256)
    opts = decoding.DecodeOptions(max_tokens=16, suppress_tokens=tuple(
        range(50257, 51864)), no_speech_token=50361, cross_kv_bits=4)
    cfg = TorchConfig(compute_dtype="float32", cross_kv_bits=4,
                      max_decode_tokens=16)
    outs, counted = {}, {}
    with _measured(torch.device("cuda"), counted):
        for dev in ("cuda", "cpu"):
            model = copy.deepcopy(cpu_model).to(dev)
            dec = decoding.greedy_decode_from_audio(
                model, torch.from_numpy(audio).to(dev),
                torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev),
                dims, opts, 4)
            b = ModelBundle(torch_config=cfg, device=dev)
            b._whisper = (model, dims, ByteFallbackTokenizer())
            b._loaded = True
            texts = b.transcribe_batch(audio, ["", "a prompt"], temperature=0.0)
            outs[dev] = (dec["tokens"].cpu(), texts)
    launches = counted["launches"]
    same_tokens = torch.equal(outs["cuda"][0], outs["cpu"][0])
    same_texts = outs["cuda"][1] == outs["cpu"][1]
    log(f"[int4] 2-layer d=768 f32 t=0 cross_kv_bits=4, card vs CPU: tokens "
        f"identical {same_tokens}, texts identical {same_texts}, kernel "
        f"launches on the card {launches}")
    if not (same_tokens and same_texts and min(launches.values()) > 0):
        raise SystemExit("int4: card and CPU disagree")

    model, wdims, _ = bundle._whisper
    base = bundle.torch_config
    mel = log_mel_auto(pad_or_trim(torch.from_numpy(np.asarray(host_batch))
                                   .cuda(), WINDOW), wdims.n_mels)
    full = {8: [], 4: []}
    for bits in (8, 4, 4, 8):         # in turns: 8, 4, 4, 8
        with torch.inference_mode():
            enc = whisper_encode(model, mel, wdims, bundle._cdt)
            ckv = precompute_cross_kv(model, enc, wdims.n_text_head, bits=bits)
        at_rest = sum(t.numel() * t.element_size() for layer in ckv
                      for entry in layer.values()
                      for t in (entry.values() if isinstance(entry, dict)
                                else [entry]) if torch.is_tensor(t))
        del enc, ckv
        bundle.torch_config = dataclasses.replace(base, cross_kv_bits=bits)
        timer = StageTimer(sync=True)
        bundle.decode_timer = timer
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            texts = bundle.transcribe_batch(host_batch, [""] * N_SEG,
                                            temperature=0.1)
            torch.cuda.synchronize()
        finally:
            bundle.torch_config = base
            bundle.decode_timer = None
        steps = timer.counts.get("token_loop_steps", 0)
        run = {"wall_s": time.perf_counter() - t0,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "step_ms": timer.as_dict()["token_loop"] / max(steps, 1) * 1e3,
               "steps": steps, "cross_kv_bytes_at_rest": at_rest,
               "text_chars": sum(len(t) for t in texts)}
        full[bits].append(run)
        log(f"[int4] full-width transcribe_batch ({N_SEG} rows, t=0.1 best_of "
            f"{base.best_of}) at cross_kv_bits={bits}: {run['wall_s']:.3f} s, "
            f"step {run['step_ms']:.2f} ms over {steps} steps, peak "
            f"{run['peak_mem_gb']:.2f} GB, cross-KV at rest "
            f"{at_rest / 1e6:.1f} MB for {N_SEG} rows")
    return {"tokens_identical": same_tokens, "texts_identical": same_texts,
            "launches": launches, "full_width": full}


# Small enough to keep the whole script well inside its time limit.
BENCH_ARGS = ["--batch", "32", "--iters", "2", "--engine-files", "4",
              "--engine-repeats", "2", "--latency-repeats", "2"]


def phase_bench(model_dir: str):
    """``python -m clearconverse_tpu_torch.bench`` in its own process on the
    rehearsal directory. Returns its last line."""
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "clearconverse_tpu_torch.bench",
           "--model-dir", model_dir, *BENCH_ARGS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/chip_smoke_bench.log", "w") as fh:
        fh.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        raise SystemExit(f"bench exited {proc.returncode}: "
                         f"{proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    first, raw = json.loads(lines[0]), lines[-1]
    last = json.loads(raw)
    log(f"[bench] {' '.join(cmd[1:])}: {wall:.1f} s, {len(lines)} lines, the "
        f"last {len(raw)} characters:")
    log(f"[bench] {raw}")
    blocks = ("engine", "engine_ref_default", "engine_overlap")
    rtfx = [last["value"]] + [last[b].get(k, 0) for b in blocks
                              for k in ("rtfx_warm_best", "rtfx_warm_mean")]
    hot = last["hot_path"]["launches"]
    bad = [b for b in (*blocks, "latency") if not isinstance(last.get(b), dict)
           or {"error", "skipped"} & set(last[b])]
    if (len(raw) >= 2000 or first.get("engine") != {"status": "pending"}
            or last["engine"]["knobs"]["random_weights"] is not False
            or min(rtfx) <= 0 or last["latency"]["latency_best_s"] <= 0
            or min(hot.values()) == 0 or bad):
        raise SystemExit(f"bench: bad result (blocks {bad}, RTFx {rtfx}, "
                         f"hot-path launches {hot})")
    return {"wall_s": wall, "args": BENCH_ARGS, "line_chars": len(raw),
            "line": last}


def phase_parity(model_dir: str, tmp: str):
    """The parity recipe with --levers on two 24 s overlap files whose
    references come from a fresh engine on the rehearsal checkpoints (with
    the crafted frequency-selective PyanNet written in pyannote's format,
    since seeded PyanNet weights find no speaker in them)."""
    import contextlib
    import io
    from clearconverse_tpu_torch.bench import _measured, overlap_wavs
    from clearconverse_tpu_torch.config import Config, torch_config_from_env
    from clearconverse_tpu_torch.eval import dress_rehearsal as dr
    from clearconverse_tpu_torch.eval import parity
    from clearconverse_tpu_torch.models.pyannet import PyannetDims
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        craft_pyannet_freq_params)
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

    models = os.path.join(tmp, "parity_models")
    os.makedirs(models)
    for name in os.listdir(model_dir):
        if name != "segmentation":
            os.symlink(os.path.join(model_dir, name), os.path.join(models, name))
    params, pdims = craft_pyannet_freq_params(PyannetDims(), device="cuda")
    dr.write_pyannet(models, 0, pdims, params=params)
    eval_set = os.path.join(tmp, "parity_set")
    os.makedirs(eval_set)
    wavs, _ = overlap_wavs(eval_set, 2, tiles=2)
    ref = TranscriptionEngine(Config(), torch_config_from_env(),
                              model_dir=models, load_models_immediately=True)
    if ref.models.load_source != ALL_CHECKPOINT:
        raise SystemExit(f"parity: reference engine loaded {ref.models.load_source}")
    n_segments = []
    for wav in wavs:
        res = ref.process_file(wav)
        if res is None or not res["segments"]:
            raise SystemExit(f"parity: no segments for {wav}")
        n_segments.append(len(res["segments"]))
        with open(wav[:-4] + ".ref.txt", "w", encoding="utf-8") as fh:
            fh.write("".join(f"[{s.speaker_id}] {s.start:.2f}s - {s.end:.2f}s\n"
                             f"{s.transcription}\n\n" for s in res["segments"]))
    del ref
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "parity_report")
    counted: dict = {}
    t0 = time.perf_counter()
    brief = io.StringIO()
    with contextlib.redirect_stdout(brief), _measured(torch.device("cuda"),
                                                      counted):
        rc = parity.main(["--models", models, "--eval-set", eval_set,
                          "--out", out, "--levers"])
    wall = time.perf_counter() - t0
    launches = counted["launches"]
    with open(out + ".json") as fh:
        report = json.load(fh)
    levers = {name: {k: lv[k] for k in ("mean_wer", "mean_der", "delta_wer",
                                        "delta_der", "mean_rtfx")}
              for name, lv in report.get("levers", {}).items()}
    log(f"[parity] references: segments per file {n_segments}; parity --levers "
        f"in {wall:.1f} s: base mean WER {report['mean_wer']}, mean DER "
        f"{report['mean_der']}, mean RTFx {report['mean_rtfx']}; kernel "
        f"launches {launches}")
    for row in report["rows"]:
        log(f"[parity]   {row}")
    for name, lv in levers.items():
        log(f"[parity]   lever {name}: {lv}")
    if (rc != 0 or report["files"] != 2
            or any("error" in r for r in report["rows"])
            or report["mean_wer"] != 0.0 or report["mean_der"] != 0.0
            or set(levers) != set(parity.LEVERS)
            or min(launches.values()) == 0):
        raise SystemExit("parity: the base row is not WER 0 / DER 0")
    return {"wall_s": wall, "segments_per_file": n_segments,
            "mean_wer": report["mean_wer"], "mean_der": report["mean_der"],
            "rows": report["rows"], "levers": levers, "launches": launches}


# ----------------------------------- fine-tuning, beam, language, native

N_PAIRS = 8
TRAIN_ARGS = ["--model", "small.en", "--batch", "4", "--steps", "5",
              "--max_tokens", "128"]
WORDS = ("the quick brown fox jumps over a lazy dog while seven bright "
         "birds sing near the quiet river at dawn").split()


def write_pairs(data_dir: str) -> float:
    """N_PAIRS (wav, txt) pairs of 3-30 s of synthetic speech; returns the
    audio seconds."""
    from clearconverse_tpu_torch.audio.wav import write_wav
    rng = np.random.default_rng(7)
    secs = np.linspace(3.0, 30.0, N_PAIRS)
    for i, s in enumerate(secs):
        write_wav(os.path.join(data_dir, f"pair{i}.wav"),
                  synth_speech(rng, float(s)), SR)
        words = rng.choice(WORDS, int(2 * s))
        with open(os.path.join(data_dir, f"pair{i}.txt"), "w") as fh:
            fh.write(" ".join(words))
    return float(secs.sum())


def run_train_cli(argv):
    """``python -m clearconverse_tpu_torch.train`` in this process with the
    launch counts set to 0 first. Records the train state the CLI builds
    and each step's device time (a synchronize on both sides of the step)
    and masked target tokens. Returns (stdout, state, steps, launches,
    peak GB, the last batch)."""
    import contextlib
    import io
    from clearconverse_tpu_torch.ops import encoder_attention as k2
    from clearconverse_tpu_torch.ops import logmel as k1
    from clearconverse_tpu_torch.train import finetune
    from clearconverse_tpu_torch.train.__main__ import main as train_main

    states, steps, batches = [], [], []
    orig_init, orig_make = finetune.init_train_state, finetune.make_train_step

    def init_recorded(*a, **kw):
        states.append(orig_init(*a, **kw))
        return states[-1]

    def make_timed(*a, **kw):
        step = orig_make(*a, **kw)

        def timed_step(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            steps.append({"s": time.perf_counter() - t0,
                          "tokens": float(batch["loss_mask"].sum())})
            batches[:] = [batch]
            return out
        return timed_step

    finetune.init_train_state = init_recorded
    finetune.make_train_step = make_timed
    out = io.StringIO()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k1.mel_power.launches = 0
    k2.encoder_attention.launches = 0
    try:
        with contextlib.redirect_stdout(out):
            rc = train_main(argv)
    finally:
        finetune.init_train_state = orig_init
        finetune.make_train_step = orig_make
    launches = {"mel_power": k1.mel_power.launches,
                "encoder_attention": k2.encoder_attention.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0:
        raise SystemExit(f"train CLI exited {rc}: {out.getvalue()[-2000:]}")
    return out.getvalue(), states[-1], steps, launches, peak, batches[0]


def train_step_split(state, batch, reps: int = 3):
    """Device time of the three parts of a plain train step on ``state``
    (bf16 compute): the loss forward, its backward and the clipped AdamW
    update, each ended by a synchronize (median of ``reps``); and K2's
    autograd Function alone at the step's shapes, forward and backward."""
    from clearconverse_tpu_torch.ops import encoder_attention as k2
    from clearconverse_tpu_torch.train import finetune as ft

    dims = state.model.dims
    parts = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(reps):
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, (n, _) = ft.whisper_loss_sums(state.model, batch, dims,
                                         torch.bfloat16)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.no_grad():
            for p in state.model.parameters():
                p.grad.div_(n)
        state.optimizer.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(1e3 * dt)
    split = {k: float(np.median(v)) for k, v in parts.items()}
    B, D = batch["mel"].shape[0], dims.n_audio_state
    q, k, v = (torch.randn((B, 1500, D), device="cuda", dtype=torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    g = torch.randn((B, 1500, D), device="cuda", dtype=torch.bfloat16)
    split["k2_forward_ms"] = time_ms(
        lambda: k2.encoder_attention(q, k, v, dims.n_audio_head), iters=5)
    split["k2_forward_backward_ms"] = time_ms(
        lambda: torch.autograd.grad(
            k2.encoder_attention(q, k, v, dims.n_audio_head), (q, k, v), g),
        iters=5)
    return split


def phase_train(model_dir: str, tmp: str):
    """The fine-tune CLI at small.en on the rehearsal checkpoints, plain and
    with --remat --accum_steps 2. After the plain run (whose state is freed
    before the remat run starts, so the two peaks compare): a fresh card
    ModelBundle on the base plus the exported overlay, and the step's split
    into forward, backward and optimizer."""
    data = os.path.join(tmp, "train_pairs")
    os.makedirs(data)
    audio_s = write_pairs(data)
    n_steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    runs, check = {}, {}
    for label, extra in (("plain", []),
                         ("remat", ["--remat", "--accum_steps", "2"])):
        export = os.path.join(tmp, f"train_{label}")
        t0 = time.perf_counter()
        text, state, steps, launches, peak, batch = run_train_cli(
            ["--data_dir", data, "--model_dir", model_dir, "--export", export,
             *TRAIN_ARGS, *extra])
        wall = time.perf_counter() - t0
        for line in text.strip().splitlines():
            log(f"[train] {label}: {line}")
        losses = [float(line.split("loss=")[1].split()[0])
                  for line in text.splitlines() if "loss=" in line]
        step_ms = 1e3 * float(np.median([s["s"] for s in steps[1:]]))
        tok_s = float(np.median([s["tokens"] / s["s"] for s in steps[1:]]))
        runs[label] = {"wall_s": wall, "losses": losses,
                       "first_step_ms": 1e3 * steps[0]["s"],
                       "step_ms": step_ms, "step_ms_all":
                       [1e3 * s["s"] for s in steps],
                       "target_tokens_per_s": tok_s, "peak_mem_gb": peak,
                       "launches": launches}
        log(f"[train] {label}: {N_PAIRS} pairs ({audio_s:.0f} s of audio), "
            f"{n_steps} steps of batch 4 in {wall:.1f} s (model load and "
            f"data prep included): first step {1e3 * steps[0]['s']:.1f} ms, "
            f"then median {step_ms:.1f} ms, {tok_s:.0f} target tokens/s, "
            f"peak {peak:.2f} GB, kernel launches {launches}")
        if (len(losses) != 2 or not all(math.isfinite(x) for x in losses)
                or len(steps) != n_steps
                or launches["encoder_attention"]
                < state.model.dims.n_audio_layer * n_steps
                or launches["mel_power"] < N_PAIRS):
            raise SystemExit(f"train {label}: bad losses {losses} or "
                             f"launches {launches}")
        if label == "plain":
            check = check_overlay(model_dir, tmp, state.model,
                                  os.path.join(export, "whisper-ft"))
            runs[label]["split_ms"] = split = train_step_split(state, batch)
            log(f"[train] plain step split (ms, medians of 3): forward "
                f"{split['forward']:.1f}, backward {split['backward']:.1f}, "
                f"AdamW with the clip {split['optimizer']:.1f}; K2 alone at "
                f"B=4 bf16: forward {split['k2_forward_ms']:.3f}, forward + "
                f"backward {split['k2_forward_backward_ms']:.3f}")
        del state, batch
        torch.cuda.empty_cache()
    return {"audio_s": audio_s, "args": TRAIN_ARGS, "runs": runs, **check}


def check_overlay(model_dir: str, tmp: str, trained, overlay: str):
    """A fresh card ModelBundle (f32) on the base checkpoint and the
    exported ``overlay``: its Whisper must be the trained module exactly,
    and the loader must log no overlay fallback."""
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle

    ft_dir = os.path.join(tmp, "train_ft_models")
    os.makedirs(ft_dir)
    for name in os.listdir(model_dir):
        if name != "whisper-ft":
            os.symlink(os.path.join(model_dir, name), os.path.join(ft_dir, name))
    os.symlink(overlay, os.path.join(ft_dir, "whisper-ft"))
    warnings = _Errors()
    warnings.setLevel(logging.WARNING)
    logging.getLogger("clearconverse_tpu_torch").addHandler(warnings)
    try:
        bundle = ModelBundle(Config(), TorchConfig(compute_dtype="float32"),
                             model_dir=ft_dir, device="cuda")
        if not bundle.load_with_progress():
            raise SystemExit("train: the overlay bundle did not load")
    finally:
        logging.getLogger("clearconverse_tpu_torch").removeHandler(warnings)
    loaded = dict(bundle._whisper[0].named_parameters())
    err = max(float((loaded[n] - p.detach()).abs().max())
              for n, p in trained.named_parameters())
    moved = max(float((loaded[n] - p.detach()).abs().max())
                for n, p in _base_whisper(model_dir).named_parameters())
    fallback = [r.getMessage() for r in warnings.records
                if "whisper-ft" in r.getMessage()]
    log(f"[train] fresh card ModelBundle on the base + overlay: load_source "
        f"{bundle.load_source['whisper']}, max err against the trained "
        f"module {err} (f32), max distance from the base {moved:.3g}, "
        f"overlay warnings {fallback}")
    if err != 0.0 or moved == 0.0 or fallback:
        raise SystemExit("train: the bundle did not load the exported overlay")
    del bundle, loaded
    torch.cuda.empty_cache()
    return {"overlay_max_err": err, "overlay_vs_base": moved}


def _base_whisper(model_dir: str):
    from clearconverse_tpu_torch.models.convert import load_whisper
    model, _ = load_whisper(model_dir, "small.en", "cuda")
    return model


def _small_2layer(name: str = "small.en"):
    from clearconverse_tpu_torch.models.whisper import model_dims
    return dataclasses.replace(model_dims(name), n_audio_layer=2,
                               n_text_layer=2)


def phase_train_parity():
    """One loss + backward and one optimizer step at 2 layers and small.en
    width, f32, on the card (K2 forward, plain-recompute backward) and on
    the CPU (plain versions), from the same seeded weights and batch."""
    from clearconverse_tpu_torch.audio.mel import log_mel_spectrogram
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.ops import encoder_attention as k2
    from clearconverse_tpu_torch.train import finetune as ft

    dims = _small_2layer()
    rng = np.random.default_rng(8)
    audio = np.stack([np.pad(synth_speech(rng, s), (0, WINDOW - int(s * SR)))
                      for s in (6.0, 17.0)])
    mel = log_mel_spectrogram(torch.from_numpy(audio))
    tokens = rng.integers(0, 50256, (2, 32))
    mask = np.ones((2, 32), np.float32)
    mask[1, 20:] = 0.0
    base = init_whisper(dims, 11, "cpu")
    before_step = {n: p.detach().float().clone()
                   for n, p in ft.trainable_whisper(base).named_parameters()}
    res = {}
    before = k2.encoder_attention.launches
    for dev in ("cuda", "cpu"):
        model = ft.trainable_whisper(base).to(dev)
        batch = {"mel": mel.to(dev), "tokens": torch.from_numpy(tokens).to(dev),
                 "targets": torch.from_numpy(np.roll(tokens, -1, 1)).to(dev),
                 "loss_mask": torch.from_numpy(mask).to(dev)}
        s, _ = ft.whisper_loss_sums(model, batch, dims, torch.float32)
        s.backward()
        grads = {n: p.grad.cpu().clone() for n, p in model.named_parameters()}
        state = ft.init_train_state(model)
        ft.make_train_step(dims, compute_dtype=torch.float32)(state, batch)
        res[dev] = (float(s.detach()), grads,
                    {n: p.detach().cpu() for n, p in model.named_parameters()})
        del model, state, batch
    launched = k2.encoder_attention.launches - before
    torch.cuda.empty_cache()
    (sc, gc, pc), (s0, g0, p0) = res["cuda"], res["cpu"]
    loss_rel = abs(sc - s0) / abs(s0)
    grad_rel = max(float((gc[n] - g).abs().max()) / max(float(g.abs().max()),
                                                        1e-30)
                   for n, g in g0.items() if float(g.abs().max()) > 0)
    lost = [n for n, g in g0.items()
            if float(g.abs().max()) > 0 and float(gc[n].abs().max()) == 0]
    param_err = max(float((pc[n] - p).abs().max()) for n, p in p0.items())
    upd = step_update_err(before_step, pc, p0, g0)
    log(f"[train_parity] 2-layer d=768 f32, card vs CPU: loss {sc:.6f} vs "
        f"{s0:.6f} (rel {loss_rel:.3g}, limit 1e-4), worst gradient error "
        f"{grad_rel:.3g} of its largest (limit 1e-3), parameters with a "
        f"nonzero CPU gradient and a zero card one: {lost}, one AdamW step: "
        f"update max err {upd['max_err']:.3g} (limit 5e-6) over "
        f"{upd['entries']} entries whose CPU gradient is above 1e-3 of its "
        f"parameter's largest, where the CPU update is {upd['cpu_update_min']:.3g}"
        f" to {upd['cpu_update_max']:.3g} in size (lr 1e-5); parameters "
        f"max err over all entries {param_err:.3g}; K2 launches on the card "
        f"{launched}")
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-3 and not lost
            and upd["entries"] > 0 and upd["max_err"] <= 5e-6
            and launched >= 2 * 2):
        raise SystemExit("train parity: card and CPU disagree")
    return {"loss": [sc, s0], "loss_rel": loss_rel, "grad_rel": grad_rel,
            "zero_on_card": lost, "param_max_err": param_err,
            "update": upd, "k2_launches": launched}


def step_update_err(before, after_card, after_cpu, grad_cpu):
    """The step's update, after minus before, card against CPU, over the
    entries whose CPU gradient exceeds 1e-3 of its parameter's largest
    (there a first AdamW step moves by about lr whatever the gradient's
    size, so the comparison sees a missing or sign-flipped update)."""
    err, n, lo, hi = 0.0, 0, math.inf, 0.0
    for name, g in grad_cpu.items():
        sel = g.abs() > 1e-3 * float(g.abs().max())
        if not bool(sel.any()):
            continue
        d_card = (after_card[name] - before[name])[sel]
        d_cpu = (after_cpu[name] - before[name])[sel]
        err = max(err, float((d_card - d_cpu).abs().max()))
        lo = min(lo, float(d_cpu.abs().min()))
        hi = max(hi, float(d_cpu.abs().max()))
        n += int(sel.sum())
    return {"max_err": err, "entries": n, "cpu_update_min": lo,
            "cpu_update_max": hi}


def _flat(tree, prefix=""):
    if isinstance(tree, torch.nn.Module):
        return {prefix + k: v for k, v in tree.state_dict().items()}
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}.").items()}
    return {prefix: tree}


def phase_beam_language_native(model_dir: str, tmp: str):
    """Beam search card vs CPU at 2 layers, then at full width on phase 4's
    segments (timed against the default best_of 5 call); language detection
    card vs CPU on a 2-layer multilingual model; save_native/load_native
    on the rehearsal bundle."""
    from clearconverse_tpu_torch.bench import _measured
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.models import decoding
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    from clearconverse_tpu_torch.utils.tracing import StageTimer

    dims = _small_2layer()
    cpu_model = init_whisper(dims, seed=1, device="cpu")
    rng = np.random.default_rng(9)
    audio = np.stack([np.pad(synth_speech(rng, s), (0, WINDOW - int(s * SR)))
                      for s in (8.0, 21.0)])
    cfg = TorchConfig(compute_dtype="float32", cross_kv_bits=16,
                      max_decode_tokens=16, beam_size=5)
    toks, lens = decoding.build_prompt_batch([[50257, 50362]] * 10, 4, 50256)
    opts = decoding.DecodeOptions(max_tokens=16, suppress_tokens=tuple(
        range(50257, 51864)), no_speech_token=50361, replicas=5, beam=True)
    outs, counted = {}, {}
    with _measured(torch.device("cuda"), counted):
        for dev in ("cuda", "cpu"):
            model = copy.deepcopy(cpu_model).to(dev)
            dec = decoding.greedy_decode_from_audio(
                model, torch.from_numpy(audio).to(dev),
                torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev),
                dims, opts, 4)
            b = ModelBundle(torch_config=cfg, device=dev)
            b._whisper = (model, dims, ByteFallbackTokenizer())
            b._loaded = True
            texts = b.transcribe_batch(audio, ["", "a prompt"],
                                       temperature=0.0)
            outs[dev] = (dec["tokens"].cpu(), dec["sum_logprob"].cpu(), texts)
    same_tokens = torch.equal(outs["cuda"][0], outs["cpu"][0])
    same_texts = outs["cuda"][2] == outs["cpu"][2]
    slp_err = float((outs["cuda"][1] - outs["cpu"][1]).abs().max())
    log(f"[beam] 2-layer d=768 f32 beam_size 5 t=0, card vs CPU: tokens "
        f"identical {same_tokens}, texts identical {same_texts}, sum-logprob "
        f"max err {slp_err:.3g}, kernel launches on the card "
        f"{counted['launches']}")
    if not (same_tokens and same_texts
            and min(counted["launches"].values()) > 0):
        raise SystemExit("beam: card and CPU disagree")

    # Full width on phase 4's segments: beam_size 5 at t=0 against the
    # default call (t=0.1, best_of 5), in turns.
    bundle = ModelBundle(Config(), TorchConfig(), model_dir=model_dir,
                         device="cuda")
    if not bundle.load_with_progress():
        raise SystemExit("beam: the rehearsal bundle did not load")
    _, _, _, host_batch, audio_s = main_segments()
    base = bundle.torch_config
    calls = {"beam5_t0": [], "best_of5_t0.1": []}
    steps = {"beam5_t0": [], "best_of5_t0.1": []}
    launches = {}
    for label in ("beam5_t0", "best_of5_t0.1", "best_of5_t0.1", "beam5_t0"):
        beam = label.startswith("beam")
        bundle.torch_config = dataclasses.replace(
            base, beam_size=5 if beam else base.beam_size)
        counted = {}
        bundle.decode_timer = timer = StageTimer()
        try:
            with _measured(torch.device("cuda"), counted):
                t0 = time.perf_counter()
                texts = bundle.transcribe_batch(
                    host_batch, [""] * N_SEG, temperature=0.0 if beam else 0.1)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            bundle.torch_config = base
            bundle.decode_timer = None
        calls[label].append(wall)
        steps[label].append(timer.counts.get("token_loop_steps", 0))
        launches[label] = counted["launches"]
        if len(texts) != N_SEG or not all(isinstance(t, str) for t in texts):
            raise SystemExit(f"beam: bad transcribe_batch result ({label})")
    log(f"[beam] full-width transcribe_batch on phase 4's {N_SEG} segments "
        f"({audio_s:.1f} s): beam_size 5 t=0 {calls['beam5_t0']} s, default "
        f"t=0.1 best_of 5 {calls['best_of5_t0.1']} s; token-loop steps "
        f"{steps}; launches {launches}")
    if min(launches["beam5_t0"].values()) == 0:
        raise SystemExit("beam: a kernel was never launched")

    # Language detection: 2-layer multilingual small (51865 vocab).
    mdims = _small_2layer("small")
    mmodel = init_whisper(mdims, seed=3, device="cpu")
    sp = ByteFallbackTokenizer(english=False).specials
    rows = np.stack([np.pad(synth_speech(rng, s), (0, WINDOW - int(s * SR)))
                     for s in (4.0, 12.0, 25.0)])
    ids = {}
    for dev in ("cuda", "cpu"):
        ids[dev] = decoding.detect_language_from_audio(
            copy.deepcopy(mmodel).to(dev), torch.from_numpy(rows).to(dev),
            mdims, sp.sot, sp.sot + 1, sp.translate).cpu()
    same_ids = torch.equal(ids["cuda"], ids["cpu"])
    log(f"[language] 2-layer small (51865 vocab) f32: detected ids card "
        f"{ids['cuda'].tolist()}, CPU {ids['cpu'].tolist()} -> "
        f"{'identical' if same_ids else 'DIFFER'}")
    if not same_ids:
        raise SystemExit("language: card and CPU disagree")

    # save_native / load_native on the rehearsal bundle.
    path = os.path.join(tmp, "native.pt")
    t0 = time.perf_counter()
    bundle.save_native(path)
    save_s = time.perf_counter() - t0
    back = ModelBundle(Config(), TorchConfig(), model_dir=model_dir,
                       device="cuda")
    t0 = time.perf_counter()
    back.load_native(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    native_err = 0.0
    for get in (lambda b: b._whisper[0], lambda b: b._ecapa,
                lambda b: b._pyannet, lambda b: b._sepformer):
        a, b2 = _flat(get(bundle)), _flat(get(back))
        if a.keys() != b2.keys():
            raise SystemExit("native: the families' names differ")
        for k in a:
            native_err = max(native_err, float(
                (a[k].float() - b2[k].float()).abs().max()))
    same_dims = (back._whisper[1] == bundle._whisper[1]
                 and back._ecapa_dims == bundle._ecapa_dims
                 and back._pyannet_dims == bundle._pyannet_dims
                 and back._sepformer.dims == bundle._sepformer.dims)
    size_mb = os.path.getsize(path) / 1e6
    log(f"[native] save_native {size_mb:.0f} MB in {save_s:.1f} s, "
        f"load_native in {load_s:.1f} s: max err {native_err}, dims equal "
        f"{same_dims}, load_source {back.load_source}")
    if native_err != 0.0 or not same_dims:
        raise SystemExit("native: the round trip is not exact")
    os.remove(path)
    del bundle, back
    torch.cuda.empty_cache()
    return {"beam_card_vs_cpu": {"tokens_identical": same_tokens,
                                 "texts_identical": same_texts,
                                 "sum_logprob_max_err": slp_err},
            "full_width_s": calls, "full_width_steps": steps,
            "launches": launches,
            "language_ids": ids["cuda"].tolist(),
            "native": {"size_mb": size_mb, "save_s": save_s,
                       "load_s": load_s, "max_err": native_err}}


# ------------------------------------------------ mesh, int8 decoder weights

MESH_TOKENS = 32        # decode length of phase 17's calls
INT8_BATCHES = (8, 32, 128)


def transcribe_tokens(bundle, audio, prompts, temperature=0.0,
                      all_rows=False):
    """transcribe_batch, and the tokens of its (last) decode call (of its
    first len(prompts) rows, or of every row, beams included)."""
    import clearconverse_tpu_torch.pipeline.bundle as bundle_mod
    inner, calls = bundle_mod._unpack_decode, []

    def record(out, max_tokens):
        calls.append(inner(out, max_tokens))
        return calls[-1]

    bundle_mod._unpack_decode = record
    try:
        texts = bundle.transcribe_batch(audio, prompts,
                                        temperature=temperature)
    finally:
        bundle_mod._unpack_decode = inner
    tokens = np.asarray(calls[-1][0])
    return texts, tokens if all_rows else tokens[:len(prompts)]


def mesh_whisper(device):
    """Phase 17's Whisper: small.en width (12 heads, 768 wide), 2 encoder
    and 2 decoder layers, seeded, with byte_text so texts are not empty."""
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.whisper import model_dims
    dims = dataclasses.replace(model_dims("small.en"), n_audio_layer=2,
                               n_text_layer=2)
    return byte_text(init_whisper(dims, seed=1, device=device)), dims


def mesh_bundle(device, data: int, model: int):
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    b = ModelBundle(Config(), TorchConfig(
        compute_dtype="float32", max_decode_tokens=MESH_TOKENS,
        data_axis=data, model_axis=model), device=device)
    whisper, dims = mesh_whisper(device)
    b._whisper = (whisper, dims, ByteFallbackTokenizer())
    b._loaded = True
    return b


def mesh_rank(devices, audio, prompts):
    """One of phase 17's two ranks: transcribe_batch at 1x2 and at 2x1,
    each with the launch counters set to 0 just before and read just after
    on every rank, and this rank's heads in K2."""
    import torch.distributed as dist
    from clearconverse_tpu_torch.models.whisper import tensor_parallel
    from clearconverse_tpu_torch.ops import encoder_attention as k2
    from clearconverse_tpu_torch.ops import logmel as k1

    device = torch.device(devices[dist.get_rank()])
    out = {}
    for data, model in ((1, 2), (2, 1)):
        b = mesh_bundle(device, data, model)
        _ = b.mesh
        k1.mel_power.launches = 0
        k2.encoder_attention.launches = 0
        texts, tokens = transcribe_tokens(b, audio, prompts)
        torch.cuda.synchronize()
        shard, dims, _ = b._whisper_on_mesh()
        tp = tensor_parallel(shard)
        mine = {"k1": k1.mel_power.launches,
                "k2": k2.encoder_attention.launches,
                "k2_heads": (dims.n_audio_head if tp is None
                             else tp.heads(dims.n_audio_head)),
                "q_width": int(shard.encoder.blocks[0].attn.q.weight.shape[0])}
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
        out[f"{data}x{model}"] = {"texts": texts, "tokens": tokens,
                                  "ranks": ranks}
        del b, shard
    return out


def int8_decoder_timing(bundle, host_batch):
    """Phase 4's segments on the rehearsal bundle with an int8 decoder and
    with its own bf16 one, in turns (int8, bf16, bf16, int8) at B = 8, 32
    and 128 (the 8 segments tiled), t=0, MESH_TOKENS tokens: the token
    loop's step time, peak memory, valid token ids, K1/K2 launches."""
    from clearconverse_tpu_torch.bench import _measured
    from clearconverse_tpu_torch.ops.quantize import quantize_whisper_decoder
    from clearconverse_tpu_torch.utils.tracing import StageTimer

    model, dims, tok = bundle._whisper
    qmodel = quantize_whisper_decoder(model)
    base = bundle.torch_config
    runs = {}
    try:
        bundle.torch_config = dataclasses.replace(
            base, max_decode_tokens=MESH_TOKENS)
        for B in INT8_BATCHES:
            audio = np.tile(np.asarray(host_batch), (B // N_SEG, 1))
            runs[B] = {"int8": [], "bf16": []}
            for label in ("int8", "bf16", "bf16", "int8"):
                bundle._whisper = (qmodel if label == "int8" else model,
                                   dims, tok)
                timer = StageTimer(sync=True)
                bundle.decode_timer = timer
                counted: dict = {}
                with _measured(torch.device("cuda"), counted):
                    t0 = time.perf_counter()
                    _, tokens = transcribe_tokens(bundle, audio, [""] * B)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                steps = timer.counts.get("token_loop_steps", 0)
                run = {"wall_s": wall, "steps": steps,
                       "step_ms": timer.as_dict()["token_loop"]
                       / max(steps, 1) * 1e3,
                       "peak_mem_gb": counted["peak_mem_gb"],
                       "launches": counted["launches"],
                       "tokens_valid": bool(((tokens >= 0)
                                             & (tokens < dims.n_vocab)).all())}
                runs[B][label].append(run)
                log(f"[int8] B={B} {label} decoder: {wall:.3f} s, step "
                    f"{run['step_ms']:.3f} ms over {steps} steps, peak "
                    f"{run['peak_mem_gb']:.2f} GB, launches "
                    f"{run['launches']}")
                if not run["tokens_valid"] or \
                        min(run["launches"].values()) == 0:
                    raise SystemExit("int8: invalid tokens or a kernel "
                                     "that did not launch")
    finally:
        bundle._whisper = (model, dims, tok)
        bundle.torch_config = base
        bundle.decode_timer = None
    decoder_linears = [m for blk in model.decoder.blocks
                       for m in (blk.attn.q, blk.attn.k, blk.attn.v,
                                 blk.attn.out, blk.cross.q, blk.cross.k,
                                 blk.cross.v, blk.cross.out, blk.mlp.fc1,
                                 blk.mlp.fc2)]
    return {"runs": runs, "tokens": MESH_TOKENS,
            "decoder_linear_mb": {
                "bf16": sum(m.weight.numel() * m.weight.element_size()
                            for m in decoder_linears) / 1e6,
                "int8": sum(m.weight.numel() for m in decoder_linears) / 1e6}}


def phase_mesh_quantize(bundle, host_batch):
    """Phase 17: two ranks sharing the card over gloo at 1x2 and 2x1
    against the 1x1 card call; dryrun_multichip(2) on the card; the int8
    decoder timed against the bf16 one on the rehearsal bundle."""
    from clearconverse_tpu_torch import entry
    from clearconverse_tpu_torch.parallel.launch import run_group

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    log(f"[mesh] compute mode {mode}")
    if "exclusive" in mode.lower():
        raise SystemExit(f"mesh: compute mode {mode} refuses two processes "
                         "on one card")
    audio = np.asarray(host_batch)
    prompts = ["", "a prompt"] * (N_SEG // 2)
    texts_1x1, tokens_1x1 = transcribe_tokens(mesh_bundle("cuda", 1, 1),
                                              audio, prompts)
    t0 = time.perf_counter()
    meshes = run_group(mesh_rank, ["cuda:0", "cuda:0"],
                       args=(audio, prompts), timeout_s=300)
    mesh_s = time.perf_counter() - t0
    for name, res in meshes.items():
        same_tokens = bool(np.array_equal(res["tokens"], tokens_1x1))
        same_texts = res["texts"] == texts_1x1
        res.update(tokens_identical=same_tokens, texts_identical=same_texts)
        log(f"[mesh] {name} on two ranks of cuda:0 (gloo), 2-layer "
            f"small.en width f32 t=0, {N_SEG} rows: tokens identical to 1x1 "
            f"{same_tokens}, texts identical {same_texts}; per rank "
            f"{res['ranks']}")
        if not (same_tokens and same_texts):
            raise SystemExit(f"mesh: {name} differs from 1x1")
        if min(min(r["k1"], r["k2"]) for r in res["ranks"]) == 0:
            raise SystemExit(f"mesh: a kernel did not launch on a rank at "
                             f"{name}")
    if any(r["k2_heads"] != 6 or r["q_width"] != 384
           for r in meshes["1x2"]["ranks"]):
        raise SystemExit("mesh: K2 did not run with 6 heads a rank at 1x2")
    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(2, device="cuda")
    dry_s = time.perf_counter() - t0
    log(f"[mesh] dryrun_multichip(2, cuda) in {dry_s:.1f} s: mesh "
        f"{dry['mesh']} on {dry['devices']}, loss {dry['loss']:.4f}")
    int8 = int8_decoder_timing(bundle, host_batch)
    return {"compute_mode": mode, "meshes": meshes, "mesh_s": mesh_s,
            "dryrun": {"mesh": dry["mesh"], "devices": dry["devices"],
                       "loss": dry["loss"], "seconds": dry_s},
            "int8_decoder": int8}


# ------------------------------------------- decode graphs (phase 18)

# The phases whose card decodes take the default route (phases 3-11, 13,
# 16-22); the train phases decode nothing and the bench runs elsewhere.
GRAPH_PHASES = ("slice", "main", "engine", "engine_parity", "overlap",
                "overlap_parity", "serve", "rehearsal", "int4", "parity",
                "beam_language_native", "mesh_quantize", "decode_graphs",
                "beam_graphs", "bf16_contract", "warmup", "voxtral")

GRAPH_BATCHES = (8, 32, 128)
GRAPH_TOKENS = 96       # the bench hot path's decode length


@contextlib.contextmanager
def eager_route():
    """The token loop's eager route on the card, for the graphs' reference
    (decoding._graph_route is the route's one decision)."""
    from clearconverse_tpu_torch.models import decoding
    orig = decoding._graph_route
    decoding._graph_route = lambda model, dev: False
    try:
        yield
    finally:
        decoding._graph_route = orig


def noise_rows(B: int, seed: int) -> torch.Tensor:
    """B rows of 30 s of seeded noise on the card."""
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (B, WINDOW)).astype(np.float32) * 0.1).cuda()


def hot_path_call(model, dims, rows: int, cdt, kind: str = "greedy",
                  mesh=None):
    """The bench hot path's decode on this rank (30 s of seeded noise,
    [SOT], GRAPH_TOKENS tokens with EOT off or suppressed, int8 cross-KV):
    ``kind`` "greedy" on ``rows`` rows, "beam" on rows x BEAM_WIDTH beams,
    "best_of" rows x BEAM_WIDTH samples at t=0.1; on a mesh with data > 1
    this data rank's block of the rows (sampling noise drawn for the whole
    batch). A function of an optional StageTimer whose result carries the
    whole batch's packed rows (gathered over the data axis)."""
    from clearconverse_tpu_torch.audio.mel import log_mel_auto
    from clearconverse_tpu_torch.models import decoding
    from clearconverse_tpu_torch.parallel.mesh import DATA_AXIS

    R = 1 if kind == "greedy" else BEAM_WIDTH
    audio = noise_rows(rows, {"greedy": 0, "beam": 1, "best_of": 2}[kind])
    sl, noise = slice(0, rows), (0, 0)
    if mesh is not None and mesh.data > 1:
        sl = mesh.rows(rows)
        noise = (sl.start * R, rows * R)
    audio = audio[sl]
    B = audio.shape[0] * R
    toks, lens = decoding.build_prompt_batch([[50257]] * B, 1, 50256)
    toks, lens = torch.from_numpy(toks).cuda(), torch.from_numpy(lens).cuda()
    kw = dict(max_tokens=GRAPH_TOKENS, suppress_blank=False,
              compute_dtype=cdt, cross_kv_bits=8, replicas=R,
              noise_rows=noise)
    if kind == "beam":
        kw.update(beam=True,
                  suppress_tokens=(50256,) + tuple(range(50257, 51864)))
    else:
        kw.update(eot=-1, temperature=0.1 if kind == "best_of" else 0.0)
    opts = decoding.DecodeOptions(**kw)

    def call(timer=None):
        mel = log_mel_auto(audio, n_mels=dims.n_mels)
        if kind == "beam":
            out = decoding.beam_decode(model, mel, toks, lens, dims, opts, 1,
                                       timer=timer)
        else:
            gen = (torch.Generator(device="cuda").manual_seed(7)
                   if kind == "best_of" else None)
            out = decoding.greedy_decode(model, mel, toks, lens, dims, opts,
                                         1, gen, timer=timer)
        if mesh is not None and mesh.data > 1:
            out["packed"] = mesh.all_gather(out["packed"], DATA_AXIS)
        return out
    return call


def graph_call_record(call, graphs, timer):
    """One call with the decode graphs' counts taken around it."""
    from clearconverse_tpu_torch.models import decode_graph
    before = dict(graphs.stats)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = call(timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = {k: graphs.stats[k] - before[k] for k in before}
    rec = {"wall_s": wall, "steps": out["steps"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "replays": d["replays"], "flag_reads": d["flag_reads"],
           "captures": d["captures"], "capture_s": d["capture_s"],
           "flag_read_limit": -(-out["steps"] // decode_graph.K) + 1}
    if timer is not None:
        rec["step_ms"] = (timer.as_dict()["token_loop"]
                          - timer.as_dict().get("graph_capture", 0.0)) \
            / max(out["steps"] - 1, 1) * 1e3
    return out, rec


def phase_decode_graphs(bundle, host_batch, profile: bool):
    """Phase 18: the token loop as CUDA graphs against the eager loop on
    the rehearsal bundle's small.en: identical tokens at t=0 in bf16 and
    f32 on phase 4's rows (transcribe_batch) and on the bench hot path's
    B=128; then the hot path's call at B = 8, 32, 128 in bf16, eager and
    graph in turns: step ms, call wall and RTFx, replays, stop-flag reads,
    capture seconds, arena and pool GB, peak memory against eager."""
    from clearconverse_tpu_torch.models import decode_graph
    from clearconverse_tpu_torch.utils.tracing import StageTimer

    model, dims, _ = bundle._whisper
    graphs = decode_graph.graphs_for(model)
    base = bundle.torch_config
    identity = {}
    try:
        for cdt, name in ((torch.bfloat16, "bfloat16"),
                          (torch.float32, "float32")):
            bundle.torch_config = dataclasses.replace(base, compute_dtype=name)
            rows = {}
            for route in ("eager", "graph"):
                with eager_route() if route == "eager" \
                        else contextlib.nullcontext():
                    rows[route] = transcribe_tokens(
                        bundle, np.asarray(host_batch), [""] * N_SEG)
            hot = {}
            for route in ("eager", "graph"):
                call = hot_path_call(model, dims, 128, cdt)
                with eager_route() if route == "eager" \
                        else contextlib.nullcontext():
                    out = call()
                hot[route] = (out["packed"].cpu(), out["steps"])
            identity[name] = {
                "rows8_tokens_identical": bool(np.array_equal(
                    rows["eager"][1], rows["graph"][1])),
                "rows8_texts_identical": rows["eager"][0] == rows["graph"][0],
                "b128_packed_identical": bool(torch.equal(
                    hot["eager"][0], hot["graph"][0])),
                "b128_steps": [hot["eager"][1], hot["graph"][1]]}
            graphs.release()
            torch.cuda.empty_cache()
            log(f"[graphs] t=0 {name}: graph vs eager {identity[name]}")
            if not all(v for k, v in identity[name].items()
                       if k != "b128_steps"):
                raise SystemExit(f"graphs: the graph route differs from the "
                                 f"eager loop in {name}")
    finally:
        bundle.torch_config = base

    timing = {}
    for B in GRAPH_BATCHES:
        call = hot_path_call(model, dims, B, torch.bfloat16)
        graphs.release()
        torch.cuda.empty_cache()
        with eager_route():
            _, eager1 = graph_call_record(call, graphs, StageTimer(sync=True))
        _, capture = graph_call_record(call, graphs, StageTimer(sync=True))
        _, graph1 = graph_call_record(call, graphs, StageTimer(sync=True))
        arena_gb = graphs.arena_bytes / 1e9
        pool_gb = graphs.pool_bytes() / 1e9
        with eager_route():
            _, eager2 = graph_call_record(call, graphs, None)
        _, graph2 = graph_call_record(call, graphs, None)
        run = {"eager": [eager1, eager2], "capture_call": capture,
               "graph": [graph1, graph2], "arena_gb": arena_gb,
               "pool_gb": pool_gb,
               "rtfx": {"eager": B * 30.0 / eager2["wall_s"],
                        "graph": B * 30.0 / graph2["wall_s"]},
               "peak_vs_eager": graph1["peak_mem_gb"] / eager1["peak_mem_gb"]}
        timing[B] = run
        log(f"[graphs] B={B} bf16 hot path, {GRAPH_TOKENS} tokens: step ms "
            f"eager {eager1['step_ms']:.3f}, graph {graph1['step_ms']:.3f}; "
            f"call wall eager {eager2['wall_s']:.3f} s, graph "
            f"{graph2['wall_s']:.3f} s (RTFx {run['rtfx']['eager']:.0f} / "
            f"{run['rtfx']['graph']:.0f}); capture {capture['captures']} in "
            f"{capture['capture_s']:.3f} s; replays {graph1['replays']}, "
            f"stop-flag reads {graph1['flag_reads']} (limit "
            f"{graph1['flag_read_limit']}); arena {arena_gb:.3f} GB, pool "
            f"{pool_gb:.3f} GB; peak {graph1['peak_mem_gb']:.3f} GB against "
            f"eager {eager1['peak_mem_gb']:.3f} GB "
            f"({run['peak_vs_eager']:.3f}x)")
        for rec in (capture, graph1, graph2):
            if rec["replays"] == 0 or rec["flag_reads"] > rec["flag_read_limit"]:
                raise SystemExit(f"graphs: B={B} replays {rec['replays']}, "
                                 f"stop-flag reads {rec['flag_reads']}")
        if capture["captures"] != 1 or graph1["captures"] or graph2["captures"]:
            raise SystemExit(f"graphs: B={B} captured at the wrong call")
    res = {"identity": identity, "timing": timing,
           "stats": dict(graphs.stats), "k": decode_graph.K}
    if profile:
        call = hot_path_call(model, dims, 128, torch.bfloat16)
        call()
        with eager_route():
            res["profile_eager"] = profile_call(
                call, timing[128]["eager"][1]["wall_s"], "graphs-eager")
        res["profile_graph"] = profile_call(
            call, timing[128]["graph"][1]["wall_s"], "graphs-graph")
    graphs.release()
    torch.cuda.empty_cache()
    return res


# ------------------------------------------- beam search graphs (phase 19)

BEAM_WIDTH = 5
BEAM_ROWS = (8, 32)     # unique rows; decode rows are BEAM_WIDTH times more


def kv_reorder_bytes(dims, B: int, slots: int, itemsize: int = 2) -> int:
    """Bytes of one step's in-place self-KV reorder: every layer's K and V
    cache (B rows × width × slots) gathered into a temporary and copied
    back, each pass reading and writing it once."""
    cache = dims.n_text_layer * 2 * B * dims.n_text_state * slots * itemsize
    return 4 * cache


def phase_beam_graphs(bundle, host_batch):
    """Phase 19: beam search as CUDA graphs against the eager beam loop on
    the rehearsal bundle's small.en: beam_size 5 at t=0 on phase 4's rows
    (transcribe_batch) in bf16 and f32, identical tokens (every beam's) and
    texts, K1 and K2 launching on the graph route; then beam_decode at the
    hot path's shapes at 8 and 32 unique rows × 5 beams in bf16, eager and
    graph in turns: step ms, call wall and RTFx, replays, captures,
    stop-flag reads, peak memory against eager."""
    from clearconverse_tpu_torch.bench import _measured
    from clearconverse_tpu_torch.models import decode_graph
    from clearconverse_tpu_torch.utils.tracing import StageTimer

    model, dims, _ = bundle._whisper
    graphs = decode_graph.graphs_for(model)
    graphs.release()
    torch.cuda.empty_cache()
    base = bundle.torch_config
    identity, launches = {}, {}
    try:
        for name in ("bfloat16", "float32"):
            bundle.torch_config = dataclasses.replace(
                base, compute_dtype=name, beam_size=BEAM_WIDTH)
            rows, counted = {}, {}
            for route in ("eager", "graph"):
                with eager_route() if route == "eager" \
                        else contextlib.nullcontext():
                    with _measured(torch.device("cuda"), counted):
                        rows[route] = transcribe_tokens(
                            bundle, np.asarray(host_batch), [""] * N_SEG,
                            temperature=0.0, all_rows=True)
                launches[f"{name}_{route}"] = counted["launches"]
            identity[name] = {
                "decode_rows": int(rows["graph"][1].shape[0]),
                "tokens_identical": bool(np.array_equal(
                    rows["eager"][1], rows["graph"][1])),
                "texts_identical": rows["eager"][0] == rows["graph"][0]}
            graphs.release()
            torch.cuda.empty_cache()
            log(f"[beam graphs] beam_size {BEAM_WIDTH} t=0 {name} on phase "
                f"4's {N_SEG} rows: graph vs eager {identity[name]}; K1/K2 "
                f"launches eager {launches[name + '_eager']}, graph "
                f"{launches[name + '_graph']}")
            if not (identity[name]["tokens_identical"]
                    and identity[name]["texts_identical"]):
                raise SystemExit(f"beam graphs: the graph route differs "
                                 f"from the eager beam loop in {name}")
            if min(launches[name + "_graph"].values()) == 0:
                raise SystemExit("beam graphs: K1 or K2 did not launch on "
                                 "the beam path")
    finally:
        bundle.torch_config = base

    timing = {}
    for rows_n in BEAM_ROWS:
        B = rows_n * BEAM_WIDTH
        call = hot_path_call(model, dims, rows_n, torch.bfloat16, "beam")
        graphs.release()
        torch.cuda.empty_cache()
        with eager_route():
            _, eager1 = graph_call_record(call, graphs, StageTimer(sync=True))
        _, capture = graph_call_record(call, graphs, StageTimer(sync=True))
        _, graph1 = graph_call_record(call, graphs, StageTimer(sync=True))
        arena_gb = graphs.arena_bytes / 1e9
        pool_gb = graphs.pool_bytes() / 1e9
        with eager_route():
            _, eager2 = graph_call_record(call, graphs, None)
        _, graph2 = graph_call_record(call, graphs, None)
        reorder = kv_reorder_bytes(dims, B, 1 + GRAPH_TOKENS + decode_graph.K)
        run = {"decode_rows": B, "eager": [eager1, eager2],
               "capture_call": capture, "graph": [graph1, graph2],
               "arena_gb": arena_gb, "pool_gb": pool_gb,
               "kv_reorder_gb_per_step": reorder / 1e9,
               "kv_reorder_bound_ms": reorder / HBM_BPS * 1e3,
               "rtfx": {"eager": rows_n * 30.0 / eager2["wall_s"],
                        "graph": rows_n * 30.0 / graph2["wall_s"]},
               "peak_vs_eager": graph1["peak_mem_gb"] / eager1["peak_mem_gb"]}
        timing[rows_n] = run
        log(f"[beam graphs] {rows_n} rows x {BEAM_WIDTH} beams bf16, "
            f"{GRAPH_TOKENS} tokens: step ms eager {eager1['step_ms']:.3f}, "
            f"graph {graph1['step_ms']:.3f}; call wall eager "
            f"{eager2['wall_s']:.3f} s, graph {graph2['wall_s']:.3f} s (RTFx "
            f"{run['rtfx']['eager']:.0f} / {run['rtfx']['graph']:.0f}); "
            f"capture {capture['captures']} in {capture['capture_s']:.3f} s; "
            f"replays {graph1['replays']}, stop-flag reads "
            f"{graph1['flag_reads']} (limit {graph1['flag_read_limit']}); "
            f"KV reorder {reorder / 1e9:.3f} GB a step "
            f"({run['kv_reorder_bound_ms']:.3f} ms at the HBM rate); arena "
            f"{arena_gb:.3f} GB, pool {pool_gb:.3f} GB; peak "
            f"{graph1['peak_mem_gb']:.3f} GB against eager "
            f"{eager1['peak_mem_gb']:.3f} GB ({run['peak_vs_eager']:.3f}x)")
        for rec in (capture, graph1, graph2):
            if rec["replays"] == 0 or rec["flag_reads"] > rec["flag_read_limit"]:
                raise SystemExit(f"beam graphs: {rows_n} rows replays "
                                 f"{rec['replays']}, stop-flag reads "
                                 f"{rec['flag_reads']}")
        if capture["captures"] != 1 or graph1["captures"] or graph2["captures"]:
            raise SystemExit(f"beam graphs: {rows_n} rows captured at the "
                             f"wrong call")
        if graph1["steps"] != GRAPH_TOKENS or eager1["steps"] != GRAPH_TOKENS:
            raise SystemExit(f"beam graphs: {rows_n} rows ran "
                             f"{graph1['steps']} / {eager1['steps']} steps")
    graphs.release()
    torch.cuda.empty_cache()
    return {"identity": identity, "launches": launches, "timing": timing,
            "stats": dict(graphs.stats), "k": decode_graph.K}


# ------------------------------------------- the bf16 contract (phase 20)

JAX_BF16_BOUND = 0.05   # the JAX package's bf16 encoder bound, mean |Δ|
# Phase 18's graph step at B = 8 / 32 / 128 when the decoder rounded its
# residual stream and its logits to bf16 (PERF.md §5).
BF16_ROUNDED_STEP_MS = {8: "1.92", 32: "2.97", 128: "6.64-6.83"}


def prefill_logits(model, feats, dims, cdt):
    """Logits of an [SOT] prefill on ``feats`` (cast to ``cdt``), int8
    cross-KV as the decode reads it: [B, vocab] f32."""
    from clearconverse_tpu_torch.models import decoding
    from clearconverse_tpu_torch.models.whisper import (
        decoder_forward, init_kv_cache, precompute_cross_kv)

    B = feats.shape[0]
    ckv = [decoding._widen_codes(c, cdt) for c in precompute_cross_kv(
        model, feats.to(cdt), dims.n_text_head, bits=8)]
    kv = init_kv_cache(dims, B, 1, cdt, device="cuda")
    tokens = torch.full((B, 1), 50257, dtype=torch.long, device="cuda")
    pos = torch.zeros((B, 1), dtype=torch.long, device="cuda")
    mask = torch.zeros((B, 1, 1, 1), device="cuda")
    logits, _ = decoder_forward(model, tokens, pos, 0, kv, ckv, mask, None,
                                dims, cdt)
    return logits[:, -1]


def bf16_agreement(models, dims, audio, decode):
    """bf16 against f32 on one batch: ``models`` maps "bf16"/"f32" to
    (model, dtype); ``decode(model, mel, cdt)`` returns a decode's tokens.
    Encoder mean / max |Δ|, prefill-logit mean |Δ| and argmax flips from
    the f32 encoder output, and the token rows that differ."""
    from clearconverse_tpu_torch.audio.mel import log_mel_auto, pad_or_trim
    from clearconverse_tpu_torch.models.whisper import whisper_encode

    with torch.inference_mode():
        mel = log_mel_auto(pad_or_trim(audio, WINDOW), n_mels=dims.n_mels)
        enc = {k: whisper_encode(m, mel, dims, cdt).float()
               for k, (m, cdt) in models.items()}
        d_enc = (enc["bf16"] - enc["f32"]).abs()
        logits = {k: prefill_logits(m, enc["f32"], dims, cdt)
                  for k, (m, cdt) in models.items()}
        d_log = (logits["bf16"] - logits["f32"]).abs()
        flips = int((logits["bf16"].argmax(-1)
                     != logits["f32"].argmax(-1)).sum())
    tokens = {k: decode(m, mel, cdt).cpu() for k, (m, cdt) in models.items()}
    rows = int((tokens["bf16"] != tokens["f32"]).any(-1).sum())
    return {"rows": int(audio.shape[0]),
            "encoder_mean_abs": float(d_enc.mean()),
            "encoder_max_abs": float(d_enc.max()),
            "prefill_logit_mean_abs": float(d_log.mean()),
            "prefill_argmax_flips": flips, "token_rows_differ": rows}


def phase_bf16_contract(model_dir: str, bundle, host_batch, graphs_res):
    """Phase 20: see the module docstring."""
    from clearconverse_tpu_torch.models import decode_graph, decoding
    from clearconverse_tpu_torch.models.convert import load_whisper

    m16, dims, _ = bundle._whisper
    m32, _ = load_whisper(model_dir, "small.en", "cuda", torch.float32)
    models = {"bf16": (m16, torch.bfloat16), "f32": (m32, torch.float32)}
    voiced_toks, voiced_lens = (torch.from_numpy(x).cuda() for x in
                                decoding.build_prompt_batch(
                                    [[50257, 50362]] * N_SEG, 2, 50256))

    def voiced(model, mel, cdt):
        opts = decoding.DecodeOptions(
            max_tokens=GRAPH_TOKENS, suppress_tokens=tuple(
                range(50257, dims.n_vocab)), compute_dtype=cdt,
            cross_kv_bits=8)
        return decoding.greedy_decode(model, mel, voiced_toks, voiced_lens,
                                      dims, opts, 2)["tokens"]

    res = {"voiced": bf16_agreement(
        models, dims, torch.from_numpy(np.asarray(host_batch)).cuda(),
        voiced)}
    for B in GRAPH_BATCHES:
        res[f"noise_b{B}"] = bf16_agreement(
            models, dims, noise_rows(B, 0),
            lambda model, mel, cdt, B=B:
            hot_path_call(model, dims, B, cdt)()["tokens"])
    beam = {k: hot_path_call(m, dims, 8, cdt, "beam")()["tokens"].cpu()
            for k, (m, cdt) in models.items()}
    differ = (beam["bf16"] != beam["f32"]).any(-1)
    res["beam_8x5"] = {"decode_rows_differ": int(differ.sum()),
                       "rows_differ": int(differ.reshape(8, -1).any(-1).sum())}
    identity = {}
    for k, (m, cdt) in models.items():
        call = hot_path_call(m, dims, 8, cdt)
        with eager_route():
            eager = call()["packed"]
        identity[k] = bool(torch.equal(eager, call()["packed"]))
    res["graph_equals_eager_b8"] = identity
    call = hot_path_call(m16, dims, 32, torch.bfloat16)
    off = call()["tokens"]
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        on = call()["tokens"]
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    res["reduced_precision_reduction_rows_differ_b32"] = int(
        (on != off).any(-1).sum())
    res["graph_step_ms"] = {
        B: {"now": graphs_res["timing"][B]["graph"][0]["step_ms"],
            "bf16_rounded": BF16_ROUNDED_STEP_MS[B]} for B in GRAPH_BATCHES}
    decode_graph.graphs_for(m32).release()
    del m32
    torch.cuda.empty_cache()
    for name, r in res.items():
        log(f"[bf16] {name}: {r}")
    bad = [name for name, r in res.items() if isinstance(r, dict)
           and r.get("encoder_mean_abs", 0.0) >= JAX_BF16_BOUND]
    if bad:
        raise SystemExit(f"bf16: encoder drift at or over {JAX_BF16_BOUND} "
                         f"in {bad}")
    if not all(identity.values()):
        raise SystemExit(f"bf16: graph and eager differ at B=8: {identity}")
    return res


# ------------------------------------------- Voxtral's loop step (phase 22)

def _step_split(step_fn):
    """One eager call of ``step_fn`` under torch.profiler: the kernel time
    of the whole step and of the kernels that ran inside the device-side
    spans of the ranges ``vx.attention`` (each layer's attention block), in
    ms. By time on the device, since V1's launches go through ctypes and no
    PyTorch op owns them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [e.time_range for e in dev if e.name == "vx.attention"]
    kernels = [e.time_range for e in dev if e.name != "vx.attention"]
    inside = [k for k in kernels
              if any(s.start <= k.start < s.end for s in spans)]
    total = sum(k.elapsed_us() for k in kernels) / 1e3
    attn = sum(k.elapsed_us() for k in inside) / 1e3
    return {"step_kernel_ms": total, "attention_ms": attn,
            "rest_ms": total - attn, "kernels": len(kernels),
            "attention_kernels": len(inside), "spans": len(spans)}


def phase_voxtral():
    """Phase 22 (module docstring)."""
    from clearconverse_tpu_torch.audio.mel import log_mel_auto
    from clearconverse_tpu_torch.models import decode_graph, decoding
    from clearconverse_tpu_torch.models import voxtral as vx
    from clearconverse_tpu_torch.models.tokenizer import (
        TekkenByteTokenizer, TekkenSpecials)
    from clearconverse_tpu_torch.ops import decode_attention as da

    dims = vx.VoxtralDims()
    tok = TekkenByteTokenizer(TekkenSpecials())
    head, tail = tok.specials.prompt(tok.language_ids("en"))
    U, R, M, step = VX_ROWS, VX_REPLICAS, VX_SLOTS, VX_STEP
    B, H, dh = U * R, dims.n_kv_head, dims.head_dim
    t0 = time.perf_counter()
    model = vx.init_voxtral(dims, seed=0, device="cuda")
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0}
    audio = noise_rows(U, 22)
    with torch.inference_mode():
        mel = log_mel_auto(audio, n_mels=dims.n_mels)
        x = vx.prompt_embeddings(model, vx.encode_audio(model, mel), head,
                                 tail)
        P = x.shape[1]
        arena = decode_graph._PrefixArena(
            decode_graph.PrefixLayout(dims.n_layer, H, dh, torch.bfloat16),
            U * H * dh * P, U * H * R * dh * M, torch.device("cuda"))
        prefix, suffix = arena.views(U, R, P, M)
        vx.prefix_prefill(model, x, out=prefix)
        # Slots below step - 1: prompt positions' K/V, each replica its own.
        for pre, suf in zip(prefix, suffix):
            for name in ("k", "v"):
                suf[name][:, :, :, :step - 1] = torch.stack(
                    [pre[name][:, :, r * 7:r * 7 + step - 1]
                     for r in range(R)], dim=2)
    g = torch.Generator(device="cuda").manual_seed(22)
    prev = torch.randint(1000, dims.n_vocab, (B,), generator=g,
                         device="cuda")
    st = torch.tensor(step, device="cuda")
    kslot = torch.arange(M, device="cuda")
    impls = {"plain": da.decode_attention_plain, "kernel": da.decode_attention}

    def step_fn(impl):
        def ranged(*a):
            with torch.profiler.record_function("vx.attention"):
                return impl(*a)
        ranged.launches = 0      # step_forward reads the wrapper's count

        def run():
            vx.decode_attention = ranged
            try:
                with torch.inference_mode():
                    return vx.step_forward(model, prev, st, prefix, suffix,
                                           kslot, P)
            finally:
                vx.decode_attention = da.decode_attention
        return run

    logits = {}
    for name, impl in impls.items():
        run = step_fn(impl)
        logits[name] = run().float()
        split = _step_split(run)
        split["graph_step_ms"] = graph_ms(run)
        out[name] = split
        log(f"[voxtral] step at U={U} R={R} P={P} step={step} ({name}): "
            f"kernel time {split['step_kernel_ms']:.3f} ms of which attention "
            f"{split['attention_ms']:.3f} ms and the rest "
            f"{split['rest_ms']:.3f} ms; {split['kernels']} kernels, "
            f"{split['attention_kernels']} of them in {split['spans']} "
            f"attention spans; as a CUDA graph {split['graph_step_ms']:.3f} "
            f"ms")
    gap = float((torch.log_softmax(logits["kernel"], -1)
                 - torch.log_softmax(logits["plain"], -1)).abs().max())
    top1 = float((logits["kernel"].argmax(-1)
                  == logits["plain"].argmax(-1)).float().mean())
    out["step_logprob_gap"], out["step_top1_agree"] = gap, top1
    log(f"[voxtral] V1 step against the plain step: log-probability gap "
        f"{gap:.4f} nats, top-1 agreement {top1:.3f}")
    if not gap < VX_STEP_GAP:
        raise SystemExit(f"voxtral: V1's step logits {gap} nats from the "
                         f"plain step's (limit {VX_STEP_GAP})")
    del arena, prefix, suffix, x, mel
    torch.cuda.empty_cache()

    opts = decoding.DecodeOptions(
        max_tokens=16, temperature=0.1, eot=tok.specials.eos,
        suppress_blank=False, suppress_tokens=tok.specials.control_ids(),
        compute_dtype=torch.bfloat16, replicas=R)
    dec = decoding.voxtral_decode_from_audio(
        model, noise_rows(8, 23), head, tail, opts,
        torch.Generator(device="cuda").manual_seed(1))
    out["decode_counts"] = dec["counts"]
    log(f"[voxtral] decode of 8 rows x best_of {R}, 16 tokens: "
        f"fused_attn_layers {dec['counts']['fused_attn_layers']} (of "
        f"{dims.n_layer}), counts {dec['counts']}")
    if dec["counts"]["fused_attn_layers"] != dims.n_layer:
        raise SystemExit("voxtral: the step's layers did not run V1")
    return out


# ------------------------------------------- the serving warm-up (phase 21)

def phase_warmup(models: str):
    """Phase 21: see the module docstring. ``models`` holds the rehearsal
    checkpoints with the crafted PyanNet (phase 13's)."""
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.models import decode_graph
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine
    from clearconverse_tpu_torch.serve import warmup

    runs = {}
    for order in ("engine_first", "decode_first"):
        eng = TranscriptionEngine(Config(), TorchConfig(), model_dir=models,
                                  load_models_immediately=True)
        graphs = decode_graph.graphs_for(eng.models._whisper[0])
        engine_keys, segments = set(), []
        orig = eng.process_files

        def process_files(paths, *a, orig=orig, graphs=graphs,
                          engine_keys=engine_keys, segments=segments, **kw):
            before = set(graphs.captured())
            results = orig(paths, *a, **kw)
            segments.append(sum(len(r["segments"]) for r in results if r))
            engine_keys.update(set(graphs.captured()) - before)
            return results
        eng.process_files = process_files
        lines = []
        t0 = time.perf_counter()
        if order == "decode_first":
            warmup.run_warmup(engine_factory=lambda: eng, log=lines.append)
        else:   # the order before: every engine pass, then the shapes
            warmup.run_warmup(decode_shapes=False, engine_factory=lambda: eng,
                              log=lines.append)

            def drive(label, fn):
                t1 = time.perf_counter()
                fn()
                lines.append(f"  {label}: {time.perf_counter() - t1:.1f}s")
            warmup.warm_decode_shapes(eng, drive)
        wall = time.perf_counter() - t0
        stats = warmup.decode_graph_stats(eng.models)
        lost = engine_keys - set(graphs.captured())
        drives = [ln for ln in lines if "decode graphs:" not in ln]
        runs[order] = {"wall_s": wall, "drives": len(drives),
                       "segments_per_pass": segments,
                       "engine_keys": len(engine_keys), "lost": len(lost),
                       "stats": stats}
        log(f"[warmup] {order}: {len(drives)} drives in {wall:.1f} s, "
            f"segments per engine pass {segments}; keys first captured by "
            f"an engine pass {len(engine_keys)}, dropped by the end "
            f"{len(lost)}; decode graphs {stats}")
        graphs.release()
        del eng, graphs, orig
        torch.cuda.empty_cache()
    new = runs["decode_first"]
    if new["stats"]["arena_allocs"] != 1 or new["lost"] or \
            not min(new["segments_per_pass"]):
        raise SystemExit(f"warmup: {new}")
    return runs


# ------------------------------------------- --cards N: one card a rank

def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _torchrun(n: int, module: str, argv, env=None, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(n), "--master-addr", "127.0.0.1", "--master-port",
         str(_free_port()), "-m", module, *argv],
        env={**os.environ, **(env or {})}, **kw)


def cards_train(n: int, tmp: str):
    """The train CLI at 1x1 in this process against --mesh (n/2)x2 under
    torchrun: the rank-0 checkpoint (whole model and AdamW moments) within
    2.5 lr a step of the 1x1 one (bf16 compute: the sign of a near-zero
    gradient may flip)."""
    from clearconverse_tpu_torch.train.checkpoint import load_checkpoint
    data = os.path.join(tmp, "pairs")
    os.makedirs(data)
    write_pairs(data)
    common = ["--data_dir", data, "--model", "tiny", "--model_dir",
              os.path.join(tmp, "none"), "--steps", "2", "--batch", str(n),
              "--max_tokens", "32"]
    run_train_cli(common + ["--checkpoint", os.path.join(tmp, "a.pt")])
    mesh = f"{n // 2}x2"
    t0 = time.perf_counter()
    proc = _torchrun(n, "clearconverse_tpu_torch.train", common + [
        "--mesh", mesh, "--checkpoint", os.path.join(tmp, "b.pt"),
        "--export", os.path.join(tmp, "ft")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    out, _ = proc.communicate(timeout=400)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"cards: torchrun train --mesh {mesh} failed:\n"
                         f"{out[-3000:]}")
    a, b = (load_checkpoint(os.path.join(tmp, f)) for f in ("a.pt", "b.pt"))
    err = max(float((b["params"][k].float() - v.float()).abs().max())
              for k, v in a["params"].items())
    same_shapes = all(b["params"][k].shape == v.shape
                      for k, v in a["params"].items())
    log(f"[cards] train CLI --mesh {mesh} under torchrun ({wall:.1f} s): "
        f"checkpoint max err against 1x1 {err:.3g} (<= {2 * 2.5e-5}), "
        f"shapes equal {same_shapes}; its output: "
        f"{out.strip().splitlines()[-3:]}")
    if not same_shapes or err > 2 * 2.5e-5:
        raise SystemExit("cards: the sharded CLI's checkpoint differs")
    return {"mesh": mesh, "wall_s": wall, "max_err": err}


def _served_transcript(n: int, models: str, tmp: str, wav: str) -> dict:
    """One upload of ``wav`` through the port's server on ``models`` (f32):
    ``python -m clearconverse_tpu_torch.serve`` for n = 1, else under
    torchrun on an (n/2)x2 mesh. Returns the transcript and the times."""
    import signal
    port = _free_port()
    env = {"API_HOST": "127.0.0.1", "API_PORT": str(port),
           "MODEL_CACHE_DIR": models, "CC_TORCH_COMPUTE_DTYPE": "float32",
           # The server writes its uploads and outputs under its working
           # directory, a temporary one.
           "PYTHONPATH": os.pathsep.join([os.getcwd()] + [
               p for p in [os.environ.get("PYTHONPATH")] if p])}
    work = tempfile.mkdtemp(dir=tmp)
    kw = dict(cwd=work, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
              text=True, start_new_session=True)
    if n == 1:
        proc = subprocess.Popen(
            [sys.executable, "-m", "clearconverse_tpu_torch.serve"],
            env={**os.environ, **env}, **kw)
    else:
        env.update(CC_TORCH_DATA_AXIS=str(n // 2), CC_TORCH_MODEL_AXIS="2")
        proc = _torchrun(n, "clearconverse_tpu_torch.serve", [], env=env,
                         **kw)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 300 and proc.poll() is None:
            try:
                if _http(port, "GET", "/health", timeout=5)[0] == 200:
                    break
            except OSError:
                time.sleep(0.5)
        else:
            raise SystemExit(f"cards: the server ({n} ranks) did not come up")
        up_s = time.perf_counter() - t0
        with open(wav, "rb") as fh:
            data = fh.read()
        boundary = "ccsmokeboundary"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f"name=\"file\"; filename=\"meeting.wav\"\r\n"
                f"Content-Type: audio/wav\r\n\r\n").encode() + data + \
            f"\r\n--{boundary}--\r\n".encode()
        t0 = time.perf_counter()
        _, payload, _ = _http(port, "POST", "/upload-file", body, {
            "Content-Type": f"multipart/form-data; boundary={boundary}"})
        tid = json.loads(payload)["task_id"]
        _http(port, "POST", f"/transcribe/{tid}")
        msgs = _ws_progress(port, tid)
        request_s = time.perf_counter() - t0
        text = json.loads(_http(port, "GET", f"/transcription/{tid}")[1])
        return {"transcript": text.get("transcription", ""),
                "last_message": msgs[-1], "start_s": up_s,
                "request_s": request_s}
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
        with open(os.path.join("chiprun_out", f"cards_serve_{n}.log"),
                  "w") as fh:
            fh.write(out or "")


def cards_serve(n: int, tmp: str):
    """One upload with overlaps served by the port's server on the
    dress-rehearsal checkpoints (with the crafted PyanNet, as phase 13, and
    f32 compute): at 1x1, then under torchrun on an (n/2)x2 mesh, which
    must complete with the 1x1 transcript."""
    from clearconverse_tpu_torch.bench import overlap_wavs
    from clearconverse_tpu_torch.eval import dress_rehearsal as dr
    from clearconverse_tpu_torch.models.pyannet import PyannetDims
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        craft_pyannet_freq_params)
    models = os.path.join(tmp, "serve_models")
    dr.populate(models, "small.en", seed=0, device="cuda")
    params, pdims = craft_pyannet_freq_params(PyannetDims(), device="cuda")
    dr.write_pyannet(models, 0, pdims, params=params)
    (wav,), _ = overlap_wavs(tmp, 1, tiles=2)
    single = _served_transcript(1, models, tmp, wav)
    mesh = _served_transcript(n, models, tmp, wav)
    same = mesh["transcript"] == single["transcript"]
    lines = mesh["transcript"].count("[SPEAKER_")
    log(f"[cards] served request with overlaps, f32: 1x1 {single['request_s']:.2f} "
        f"s, {n // 2}x2 under torchrun {mesh['request_s']:.2f} s (started in "
        f"{mesh['start_s']:.1f} s); last message {mesh['last_message']}; "
        f"{lines} speaker lines; transcript identical to 1x1 {same}")
    if "error" in mesh["last_message"]["message"].lower() or not lines \
            or not same:
        raise SystemExit("cards: the served request on the mesh did not "
                         "give the 1x1 transcript")
    return {"mesh": f"{n // 2}x2", "request_s": mesh["request_s"],
            "request_1x1_s": single["request_s"], "speaker_lines": lines,
            "identical": same}


# ------------------------------------ model-sharded decode graphs (cards)

CARDS_GREEDY = GRAPH_BATCHES            # unique rows of the greedy calls
CARDS_BEAM = BEAM_ROWS                  # unique rows x BEAM_WIDTH beams
CARDS_BEST_OF = 8                       # rows x BEAM_WIDTH samples, t=0.1
CARDS_WARM_TOKENS = 32                  # the follower warm-up's decode length


def cards_meshes(n: int):
    """The model-sharded meshes of ``--cards n`` as (label, data, model,
    rows split over data): 1 x n, (n/2) x 2, and 1 x 2 for the timing
    beside 1 x n, run as the (n/2) x 2 mesh whose data rows each decode
    the whole batch (n/2 meshes of 1 x 2 side by side, so no rank idles)."""
    out = {f"1x{n}": (1, n, True), f"{n // 2}x2": (n // 2, 2, True)}
    out.setdefault("1x2", (n // 2, 2, False))
    return [(label, *spec) for label, spec in out.items()]


def agree_us(shard, reps: int = 64) -> float:
    """Device microseconds of one stop agreement (decoding._agree: the
    chunk's all-reduce of the stop pair over the model axis), from a CUDA
    graph of ``reps`` of them replayed ten times."""
    from clearconverse_tpu_torch.models import decoding
    ctl = torch.zeros(2, dtype=torch.long, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        decoding._agree(ctl, shard)
    torch.cuda.current_stream().wait_stream(stream)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        for _ in range(reps):
            decoding._agree(ctl, shard)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (10 * reps) * 1e3


def _record_pair(call, graphs):
    """Eager, then the capturing graph call, then eager and graph again,
    each with a synchronising StageTimer: the records and the four
    results."""
    from clearconverse_tpu_torch.utils.tracing import StageTimer
    recs, outs = {}, {}
    graphs.release()
    torch.cuda.empty_cache()
    for label in ("eager1", "capture", "graph1", "eager2", "graph2"):
        with eager_route() if label.startswith("eager") \
                else contextlib.nullcontext():
            outs[label], recs[label] = graph_call_record(
                call, graphs, StageTimer(sync=True))
    return recs, outs


def _tokens(out) -> np.ndarray:
    """The packed result on the host: tokens, length, then sum_logprob and
    no_speech_prob bitcast (decoding._finalize_decode)."""
    return out["packed"].cpu().numpy()


def cards_decode_rank(devices):
    """One rank of the model-sharded decode phase: small.en at full width
    (seeded), whole (1x1, graph route) and as this rank's shard on each of
    cards_meshes(n). f32 t=0: greedy and beam, graph against eager against
    1x1; bf16: greedy B = 8 / 32 / 128 and beam 8 and 32 rows x 5, eager
    and graph in turns (step ms, replays, captures, peak memory); best_of 5
    at t=0.1; then a ModelBundle at 1 x n whose rank 0 leads the warm-up's
    decode shapes and the others follow. Rank 0 returns every rank's
    records."""
    import torch.distributed as dist
    from types import SimpleNamespace

    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.models import decode_graph
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.models.whisper import (
        model_dims, tensor_parallel)
    from clearconverse_tpu_torch.parallel.mesh import build_mesh
    from clearconverse_tpu_torch.parallel.serve import follow, lead
    from clearconverse_tpu_torch.parallel.sharding import shard_whisper
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    from clearconverse_tpu_torch.serve.warmup import (
        decode_graph_stats, warm_decode_shapes)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    n, rank = dist.get_world_size(), dist.get_rank()
    dims = model_dims("small.en")
    whole = {cdt: init_whisper(dims, 0, "cuda", cdt)
             for cdt in (torch.float32, torch.bfloat16)}
    f32_calls = [("greedy", B) for B in CARDS_GREEDY] + \
        [("beam", CARDS_BEAM[0])]
    single = {}
    for kind, rows in f32_calls:
        out = hot_path_call(whole[torch.float32], dims, rows, torch.float32,
                            kind)()
        single[(kind, rows)] = _tokens(out)
    decode_graph.graphs_for(whole[torch.float32]).release()
    torch.cuda.empty_cache()

    rec = {"rank": rank, "meshes": {}}
    for name, data, model, split in cards_meshes(n):
        mesh = build_mesh(data, model, devices)
        rows_mesh = mesh if split else None
        res = {"f32": {}, "bf16": {}, "heads": None}
        shard = shard_whisper(whole[torch.float32], mesh)
        res["heads"] = tensor_parallel(shard).heads(dims.n_text_head)
        graphs = decode_graph.graphs_for(shard)
        for kind, rows in f32_calls:
            call = hot_path_call(shard, dims, rows, torch.float32, kind,
                                 rows_mesh)
            graphs.release()
            with eager_route():
                eager = _tokens(call())
            before = dict(graphs.stats)
            out = call()
            got, ref = _tokens(out), single[(kind, rows)]
            cols = GRAPH_TOKENS + 1             # tokens and the length
            slp = [x[:, cols].copy().view(np.float32) for x in (got, ref)]
            res["f32"][f"{kind}{rows}"] = {
                "graph_eq_eager": bool(np.array_equal(got, eager)),
                "graph_eq_1x1": bool(np.array_equal(got[:, :cols],
                                                    ref[:, :cols])),
                "sum_logprob_rel_1x1": float(np.max(
                    np.abs(slp[0] - slp[1]) / np.abs(slp[1]))),
                "tokens": got, "steps": out["steps"],
                "replays": graphs.stats["replays"] - before["replays"],
                "captures": graphs.stats["captures"] - before["captures"]}
        graphs.release()
        del shard, graphs
        torch.cuda.empty_cache()

        shard = shard_whisper(whole[torch.bfloat16], mesh)
        graphs = decode_graph.graphs_for(shard)
        bf16_calls = [("greedy", B) for B in CARDS_GREEDY] + \
            [("beam", r) for r in CARDS_BEAM]
        for kind, rows in bf16_calls:
            call = hot_path_call(shard, dims, rows, torch.bfloat16, kind,
                                 rows_mesh)
            recs, outs = _record_pair(call, graphs)
            res["bf16"][f"{kind}{rows}"] = {
                **recs, "arena_gb": graphs.arena_bytes / 1e9,
                "graph_eq_eager": all(
                    np.array_equal(_tokens(outs[g]), _tokens(outs[e]))
                    for g in ("capture", "graph1", "graph2")
                    for e in ("eager1", "eager2")),
                "tokens": _tokens(outs["graph1"]),
                "peak_vs_eager": recs["graph1"]["peak_mem_gb"]
                / recs["eager1"]["peak_mem_gb"]}
        call = hot_path_call(shard, dims, CARDS_BEST_OF, torch.bfloat16,
                             "best_of", rows_mesh)
        graphs.release()
        with eager_route():
            eager = _tokens(call())
        before = dict(graphs.stats)
        outs = [call(), call()]
        res["best_of"] = {
            "tokens": _tokens(outs[1]), "steps": outs[1]["steps"],
            "seeded": bool(np.array_equal(_tokens(outs[0]),
                                          _tokens(outs[1]))),
            "graph_eq_eager": bool(np.array_equal(_tokens(outs[1]), eager)),
            "replays": graphs.stats["replays"] - before["replays"],
            "valid": bool(((outs[1]["tokens"] >= 0)
                           & (outs[1]["tokens"] < dims.n_vocab)).all())}
        if name == f"1x{n}":
            res["agree_us"] = agree_us(shard)
        res["stats"] = dict(graphs.stats)
        graphs.release()
        del shard, graphs
        torch.cuda.empty_cache()
        rec["meshes"][name] = res

    # The warm-up's decode shapes on a 1 x n bundle: rank 0 leads, the
    # others follow its calls, so every rank captures the same keys.
    bundle = ModelBundle(Config(), TorchConfig(
        max_decode_tokens=CARDS_WARM_TOKENS, model_axis=n), device="cuda")
    bundle._whisper = (byte_text(init_whisper(dims, 0, "cuda",
                                              torch.bfloat16)),
                       dims, ByteFallbackTokenizer())
    bundle._loaded = True
    t0 = time.perf_counter()
    if rank == 0:
        ctl = lead(bundle)
        try:
            warm_decode_shapes(SimpleNamespace(
                models=bundle, config=Config(transcription_batch_size=8),
                torch_config=bundle.torch_config), lambda label, fn: fn())
        finally:
            ctl.close()
    else:
        follow(bundle)
    torch.cuda.synchronize()
    stats = decode_graph_stats(bundle)
    rec["warmup"] = {
        "seconds": time.perf_counter() - t0,
        "stats": stats,
        "keys": [repr(k) for k in decode_graph.graphs_for(
            bundle._whisper[0]).captured()]}
    ranks = [None] * n
    dist.all_gather_object(ranks, rec)
    return ranks


def cards_decode(n: int):
    """The model-sharded decode on n NCCL ranks (cards_decode_rank): fails
    unless, at f32 t=0, every rank's graph result equals its eager route's
    bit for bit and its tokens and lengths equal 1x1's (sum_logprob, summed
    in another order across the shards, is reported against 1x1); in bf16
    graph equals eager; every rank of a mesh gives the same tokens and
    steps and replays graphs; and the follower warm-up ends with one arena
    and the same captured keys on every rank."""
    from clearconverse_tpu_torch.parallel.launch import run_group

    t0 = time.perf_counter()
    ranks = run_group(cards_decode_rank, [f"cuda:{i}" for i in range(n)],
                      timeout_s=900)
    wall = time.perf_counter() - t0
    report = {"wall_s": wall, "meshes": {}, "warmup": []}
    bad = []
    for name, _, _, _ in cards_meshes(n):
        per = [r["meshes"][name] for r in ranks]
        summary = {"heads": per[0]["heads"], "f32": {}, "bf16": {},
                   "agree_us": [p.get("agree_us") for p in per]}
        for key in per[0]["f32"]:
            recs = [p["f32"][key] for p in per]
            ok = all(x["graph_eq_eager"] and x["graph_eq_1x1"]
                     and x["replays"] > 0 for x in recs)
            same = all(np.array_equal(x["tokens"], recs[0]["tokens"])
                       and x["steps"] == recs[0]["steps"] for x in recs)
            summary["f32"][key] = {
                "ok": ok, "ranks_equal": same, "steps": recs[0]["steps"],
                "graph_eq_eager": [x["graph_eq_eager"] for x in recs],
                "graph_eq_1x1": [x["graph_eq_1x1"] for x in recs],
                "sum_logprob_rel_1x1": recs[0]["sum_logprob_rel_1x1"],
                "replays": [x["replays"] for x in recs]}
            if not (ok and same):
                bad.append(f"{name} f32 {key}")
        for key in per[0]["bf16"]:
            recs = [p["bf16"][key] for p in per]
            same = all(np.array_equal(x["tokens"], recs[0]["tokens"])
                       and x["graph1"]["steps"] == recs[0]["graph1"]["steps"]
                       for x in recs)
            ok = all(x["graph_eq_eager"] and x["graph1"]["replays"] > 0
                     and x["capture"]["captures"] == 1 for x in recs)
            summary["bf16"][key] = {
                "ok": ok, "ranks_equal": same,
                "step_ms_eager": [[x["eager1"]["step_ms"],
                                   x["eager2"]["step_ms"]] for x in recs],
                "step_ms_graph": [[x["graph1"]["step_ms"],
                                   x["graph2"]["step_ms"]] for x in recs],
                "wall_s": [[x["eager2"]["wall_s"], x["graph2"]["wall_s"]]
                           for x in recs],
                "capture_s": [x["capture"]["capture_s"] for x in recs],
                "replays": [x["graph1"]["replays"] for x in recs],
                "flag_reads": [x["graph1"]["flag_reads"] for x in recs],
                "peak_gb": [[x["eager1"]["peak_mem_gb"],
                             x["graph1"]["peak_mem_gb"]] for x in recs],
                "peak_vs_eager": [x["peak_vs_eager"] for x in recs],
                "arena_gb": [x["arena_gb"] for x in recs]}
            if not (ok and same):
                bad.append(f"{name} bf16 {key}")
            s = summary["bf16"][key]
            log(f"[cards] {name} bf16 {key}: step ms eager "
                f"{s['step_ms_eager'][0][0]:.3f}/{s['step_ms_eager'][0][1]:.3f}"
                f", graph {s['step_ms_graph'][0][0]:.3f}/"
                f"{s['step_ms_graph'][0][1]:.3f} (rank 0); replays "
                f"{s['replays']}; peak GB eager/graph per rank "
                f"{[[round(a, 3), round(b, 3)] for a, b in s['peak_gb']]}; "
                f"graph == eager {ok}, ranks equal {same}")
        recs = [p["best_of"] for p in per]
        same = all(np.array_equal(x["tokens"], recs[0]["tokens"])
                   and x["steps"] == recs[0]["steps"] for x in recs)
        ok = all(x["seeded"] and x["valid"] and x["replays"] > 0
                 for x in recs)
        summary["best_of"] = {"ok": ok, "ranks_equal": same,
                              "graph_eq_eager": [x["graph_eq_eager"]
                                                 for x in recs],
                              "replays": [x["replays"] for x in recs]}
        if not (ok and same):
            bad.append(f"{name} best_of")
        summary["stats"] = [p["stats"] for p in per]
        log(f"[cards] {name} ({summary['heads']} heads a rank): f32 t=0 "
            f"{summary['f32']}; best_of 5 t=0.1 {summary['best_of']}; "
            f"stop agreement {summary['agree_us']} us")
        report["meshes"][name] = summary
    warm = [r["warmup"] for r in ranks]
    same_keys = all(w["keys"] == warm[0]["keys"] for w in warm)
    allocs = [w["stats"]["arena_allocs"] for w in warm]
    replays = [w["stats"]["replays"] for w in warm]
    report["warmup"] = {"seconds": [w["seconds"] for w in warm],
                        "arena_allocs": allocs, "replays": replays,
                        "graphs": [w["stats"]["graphs"] for w in warm],
                        "same_keys": same_keys}
    log(f"[cards] follower warm-up of the decode shapes at 1x{n}: "
        f"{report['warmup']}")
    if not same_keys or allocs != [1] * n or min(replays) == 0:
        bad.append("warm-up")
    log(f"[cards] model-sharded decode phase: {wall:.1f} s")
    if bad:
        raise SystemExit(f"cards: the model-sharded decode failed in {bad}")
    return report


def main_cards(n: int) -> int:
    """``--cards N``: the mesh over NCCL with one card a rank, against 1x1:
    entry.dryrun_multichip(N), the model-sharded decode graphs
    (cards_decode), the train CLI under torchrun and a served request under
    torchrun."""
    from clearconverse_tpu_torch import entry
    if torch.cuda.device_count() < n or n < 2 or n % 2:
        raise SystemExit(f"--cards {n} needs an even count >= 2 of cards; "
                         f"this host has {torch.cuda.device_count()}")
    os.makedirs("chiprun_out", exist_ok=True)
    phase_build()
    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(n, device="cuda")
    dry_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="cc_cards_")
    try:
        decode = cards_decode(n)
        train = cards_train(n, tmp)
        serve = cards_serve(n, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    with open("chiprun_out/chip_smoke_cards.json", "w") as fh:
        json.dump({"card": nvidia_smi(),
                   "dryrun": {"mesh": dry["mesh"], "devices": dry["devices"],
                              "loss": dry["loss"], "seconds": dry_s},
                   "decode": decode, "train": train, "serve": serve}, fh,
                  indent=1, default=str)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one main-path call, one engine pass and "
                         "one overlap pass with torch.profiler")
    ap.add_argument("--cards", type=int, default=0,
                    help="instead of the phases: the mesh over NCCL with one "
                         "card a rank on N cards, against 1x1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.perf_counter()
    card = nvidia_smi()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    if args.cards:
        return main_cards(args.cards)
    gen = torch.Generator(device="cuda").manual_seed(0)

    phase_s = {}
    graph_counts = {}

    def timed(name, fn, *a):
        """One phase, timed, with the decode graphs' counts set to 0 just
        before it and read just after."""
        from clearconverse_tpu_torch.models import decode_graph
        for key in decode_graph.COUNTS:
            decode_graph.COUNTS[key] = 0
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        graph_counts[name] = dict(decode_graph.COUNTS)
        log(f"[phase] {name}: {phase_s[name]:.1f} s; decode graphs "
            f"{graph_counts[name]}")
        return out

    build_s, sass = timed("build", phase_build)
    rows, kernel_extra = timed("kernels", phase_kernels, gen)
    slice_res = timed("slice", phase_slice)
    # Phases 4-9 run on seeded weights: their model directory is empty.
    seeded_dir = tempfile.mkdtemp(prefix="cc_seeded_")
    rehearsal_dir = tempfile.mkdtemp(prefix="cc_rehearsal_")
    try:
        calls, launches, breakdown = timed("main", phase_main, args.profile,
                                           seeded_dir)
        for r in rows:
            r["launches"] = launches[r["name"]]
        engine = timed("engine", phase_engine, args.profile, seeded_dir)
        parity = timed("engine_parity", phase_engine_parity)
        overlap, overlap_eng = timed("overlap", phase_overlap, args.profile,
                                     seeded_dir)
        overlap_parity = timed("overlap_parity", phase_overlap_parity)
        serve = timed("serve", phase_serve, overlap_eng)
        del overlap_eng
        torch.cuda.empty_cache()
        rehearsal, rbundle, host_batch = timed(
            "rehearsal", phase_rehearsal, os.path.join(rehearsal_dir, "models"))
        int4 = timed("int4", phase_int4, rbundle, host_batch)
        bench = timed("bench", phase_bench,
                      os.path.join(rehearsal_dir, "models"))
        parity_recipe = timed("parity", phase_parity,
                              os.path.join(rehearsal_dir, "models"),
                              rehearsal_dir)
        train = timed("train", phase_train,
                      os.path.join(rehearsal_dir, "models"), rehearsal_dir)
        train_parity = timed("train_parity", phase_train_parity)
        beam = timed("beam_language_native", phase_beam_language_native,
                     os.path.join(rehearsal_dir, "models"), rehearsal_dir)
        mesh = timed("mesh_quantize", phase_mesh_quantize, rbundle,
                     host_batch)
        graphs = timed("decode_graphs", phase_decode_graphs, rbundle,
                       host_batch, args.profile)
        beam_graphs = timed("beam_graphs", phase_beam_graphs, rbundle,
                            host_batch)
        bf16 = timed("bf16_contract", phase_bf16_contract,
                     os.path.join(rehearsal_dir, "models"), rbundle,
                     host_batch, graphs)
        del rbundle
        torch.cuda.empty_cache()
        warm = timed("warmup", phase_warmup,
                     os.path.join(rehearsal_dir, "parity_models"))
        voxtral = timed("voxtral", phase_voxtral)
    finally:
        shutil.rmtree(seeded_dir, ignore_errors=True)
        shutil.rmtree(rehearsal_dir, ignore_errors=True)
    # Every phase whose card work decodes through the default path must
    # have replayed decode graphs (the bench runs in its own process: its
    # line's blocks carry their replays).
    no_replays = [name for name in GRAPH_PHASES
                  if graph_counts[name]["replays"] == 0]
    no_replays += [f"bench.{b}" for b in ("hot_path", "engine",
                                          "engine_ref_default",
                                          "engine_overlap")
                   if bench["line"][b].get("graph_replays", 0) == 0]
    log(f"[graphs] replays by phase {graph_counts}")
    if no_replays:
        raise SystemExit(f"no decode graph replayed in {no_replays}")
    bench_launches = bench["line"]["hot_path"]["launches"]
    for r in rows:
        r["launches_by_path"] = {
            "transcription": r["launches"],
            "engine": engine["launches"][r["name"]],
            "overlap_engine": overlap["launches"][r["name"]],
            "word_timestamps": overlap["align"]["launches"][r["name"]],
            "serve": serve["launches"][r["name"]],
            "rehearsal": rehearsal["launches"][BENCH_KEY[r["name"]]],
            "int4": int4["launches"][BENCH_KEY[r["name"]]],
            "bench_hot_path": bench_launches[BENCH_KEY[r["name"]]],
            "parity": parity_recipe["launches"][BENCH_KEY[r["name"]]],
            "train": train["runs"]["plain"]["launches"][r["name"]],
            "train_remat": train["runs"]["remat"]["launches"][r["name"]],
            "beam": beam["launches"]["beam5_t0"][BENCH_KEY[r["name"]]],
            "beam_graph": beam_graphs["launches"]["bfloat16_graph"][
                BENCH_KEY[r["name"]]],
            **{f"mesh_{name}_per_rank": [
                rk[BENCH_KEY[r["name"]]] for rk in res["ranks"]]
               for name, res in mesh["meshes"].items()},
            **{f"int8_decoder_b{B}": run["int8"][0]["launches"][
                BENCH_KEY[r["name"]]]
               for B, run in mesh["int8_decoder"]["runs"].items()}}

    report = {"card": card, "build_s": build_s, "sass": sass, "kernels": rows,
              "kernel_extra": kernel_extra, "slice": slice_res,
              "main_calls": calls, "breakdown": breakdown, "engine": engine,
              "engine_parity": parity, "overlap": overlap,
              "overlap_parity": overlap_parity, "serve": serve,
              "rehearsal": rehearsal, "int4": int4, "bench": bench,
              "parity": parity_recipe, "train": train,
              "train_parity": train_parity, "beam_language_native": beam,
              "mesh_quantize": mesh, "decode_graphs": graphs,
              "beam_graphs": beam_graphs, "bf16_contract": bf16,
              "warmup": warm, "voxtral": voxtral,
              "graph_counts": graph_counts, "phase_s": phase_s,
              "total_s": time.perf_counter() - t_start}
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/chip_smoke.json", "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    for r in rows:
        for key in ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err"):
            if r[key] is not None and not math.isfinite(r[key]):
                raise SystemExit(f"{r['name']}: non-finite {key}")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
