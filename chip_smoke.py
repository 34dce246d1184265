#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (clearconverse_tpu_torch) on one card.

Phases, each fatal on failure:
  1. build   — compile every hand-written kernel from clearconverse_tpu_torch/
               csrc with nvcc (all at once); print the build seconds, ptxas's
               registers and spills, and each library's count of
               tensor-core instructions (HGMMA, HMMA) in its SASS;
  2. kernels — hold each kernel against its plain PyTorch version on the card
               at the main path's shapes (K1 on noise and on speech with
               silence; K1 and K2 bf16 also at the engine's batch of 32), and
               time kernel, plain version and, where one exists, the single
               PyTorch library call;
  3. slice   — a 2-layer model at small.en's full width, f32: transcribe_batch
               at t=0 on the card (kernels) and on the CPU (plain versions);
               identical tokens and texts, encoder output and prefill logits
               within tolerance;
  4. main    — ModelBundle at small.en dims (./models/small.en.pt if present,
               else seeded random weights) with the default TorchConfig knobs
               (bf16, int8 cross-KV, temperature 0.1, best_of 5) transcribes
               segments of a synthetic WAV as a host batch and as a StoreBatch,
               then once more at t=0; every kernel's launch count must rise;
  5. engine  — TranscriptionEngine.process_files (the user's entry point) on
               8 WAV files of 60 s at the full width of Whisper small.en,
               PyanNet and ECAPA (checkpoints from ./models if present, else
               seeded random weights): one cold pass, two timed passes; RTFx,
               the stage split, segments per file, the audio wire, peak
               device memory and K1/K2 launches. It fails on a None file, an
               ERROR log record of the port, a wire other than packed_delta,
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
               batch, peak memory (the pass's and the separation calls'),
               one separation call's split (its intra-chunk attention
               against the whole call), K1/K2 launches. It fails on a file
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
               a transcript without a [SPEAKER_ line.
Then it prints the kernels JSON line, the card's name and power limit, and,
last, {"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.

Run from the repository root:  python3 chip_smoke.py [--profile]
(--profile also traces one transcribe_batch call, one engine pass and one
overlap pass with torch.profiler: kernel time by name and the card's busy
share.)
Without a CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import logging
import math
import os
import re
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
    for B in (N_SEG, 32):
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
    extra = {"mel_power_b32": {key: val for key, val in k1_rows[32].items()
                               if key != "launches"},
             "mel_power_other_bounds": k1_bounds}

    # K2 at T=1500, D=768, H=12: bf16 (the main path's dtype) at B=N_SEG and
    # at the engine's transcription batch of 32, and f32 at B=N_SEG. q, k ~
    # N(0, 1) give logits of unit spread; v ~ 0.3 N(0, 1) as in
    # tests/test_pallas.py, so outputs stay below 0.25, where one bf16
    # rounding step of the output (both sides round it) is under 1e-3.
    T, D, H = 1500, 768, 12
    k2_rows = {}
    for B, dtype, atol in ((N_SEG, "float32", 1e-4), (N_SEG, "bfloat16", 2e-3),
                           (32, "bfloat16", 2e-3)):
        q, k, v = (torch.randn((B, T, D), generator=gen, device="cuda")
                   .mul_(scale).to(getattr(torch, dtype))
                   for scale in (1.0, 1.0, 0.3))
        out = k2.encoder_attention(q, k, v, H)
        ref = k2.encoder_attention_plain(q, k, v, H)
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
            "plain_ms": time_ms(lambda: k2.encoder_attention_plain(q, k, v, H),
                                iters=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh))}
        del q, k, v, qh, kh, vh
    rows.append(k2_rows[N_SEG])
    extra["encoder_attention_b32"] = {key: val for key, val in k2_rows[32].items()
                                      if key != "launches"}
    for label, r in [("", x) for x in rows] + [
            (" (B=32)", k1_rows[32]), (" (B=32)", k2_rows[32])]:
        log(f"[kernels] {r['name']}{label}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound")
    log(f"[kernels] encoder_attention f32 {(N_SEG, T, D)}: "
        f"{extra['encoder_attention_f32_ms']:.4f} ms")
    return rows, extra


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


def phase_main(profile: bool):
    """small.en dims, default knobs, through the user's entry points."""
    from clearconverse_tpu_torch.audio.wav import read_wav, write_wav
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.models import decoding
    from clearconverse_tpu_torch.ops import encoder_attention as k2
    from clearconverse_tpu_torch.ops import logmel as k1
    from clearconverse_tpu_torch.pipeline.batching import batch_audio
    from clearconverse_tpu_torch.pipeline.bundle import (
        ModelBundle, iter_store_batches)

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
    audio_s = sum(durations)

    t0 = time.perf_counter()
    bundle = ModelBundle(Config(), TorchConfig(), model_dir="./models")
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


def engine_wavs(tmp: str, n_files: int = 8):
    """n_files WAVs of 60 s: the speech-shaped two-speaker conversation tiled
    five times, plus band-limited noise of σ 0.01, a different draw per file
    (the JAX package's engine workload in bench.py)."""
    from clearconverse_tpu_torch.audio.wav import write_wav
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        synth_conversation_speech)
    rng = np.random.default_rng(0)
    base = np.tile(synth_conversation_speech(), 5)
    paths = []
    for i in range(n_files):
        w = rng.standard_normal(base.size + 8).astype(np.float32)
        c = np.cumsum(w, dtype=np.float64)
        noise = ((c[8:] - c[:-8]) / 8.0)[:base.size]
        noise = (noise * (0.01 / noise.std())).astype(np.float32)
        path = os.path.join(tmp, f"conv_{i}.wav")
        write_wav(path, base + noise, SR)
        paths.append(path)
    return paths, base.size / SR


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


def phase_engine(profile: bool):
    """The engine's default pass at full width through process_files; with
    ``profile``, one more pass under torch.profiler."""
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.ops import encoder_attention as k2
    from clearconverse_tpu_torch.ops import logmel as k1
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

    errors = _Errors()
    port_log = logging.getLogger("clearconverse_tpu_torch")
    port_log.addHandler(errors)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            paths, file_s = engine_wavs(tmp)
            audio_s = file_s * len(paths)
            t0 = time.perf_counter()
            tc = TorchConfig(diarization_onset=0.35, diarization_offset=0.25,
                             max_decode_tokens=64, max_fallback_attempts=1)
            eng = TranscriptionEngine(Config(noise_reduction_amount=0.2), tc,
                                      model_dir="./models",
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
            if wire.get("format") != "packed_delta":
                raise SystemExit(f"engine: the wire is {wire.get('format')}, "
                                 "not packed_delta")
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


def overlap_wav(path: str, repeats: int, scale: float = 1.0) -> None:
    """synth_conversation() (L, H, L, then L+H overlapping) tiled."""
    from clearconverse_tpu_torch.audio.wav import write_wav
    from clearconverse_tpu_torch.pipeline.dev_backend import synth_conversation
    write_wav(path, np.tile(synth_conversation(), repeats) * scale, SR)


# Phase 7's pipeline settings. min_speakers=2: seeded ECAPA embeds the
# stationary tones by their onsets as much as by their bands, and only two
# forced clusters split the speakers (PERF.md §4).
OVERLAP_CONFIG = dict(noise_reduction_amount=0.2, min_speakers=2)


def overlap_engine(device="cuda"):
    """Phase 7's engine: weights from ./models where present, else seeded
    at full width; the crafted frequency-selective PyanNet at PyannetDims()
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
                              model_dir="./models", device=device,
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


def phase_overlap(profile: bool):
    """The overlap path at full width through process_files; then one
    word-timestamp transcription call. Returns (report, engine)."""
    from clearconverse_tpu_torch.audio.wav import read_wav
    from clearconverse_tpu_torch.ops import encoder_attention as k2
    from clearconverse_tpu_torch.ops import logmel as k1
    from clearconverse_tpu_torch.pipeline.bundle import _row_bucket

    errors = _Errors()
    port_log = logging.getLogger("clearconverse_tpu_torch")
    port_log.addHandler(errors)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            paths = [os.path.join(tmp, f"overlap_{i}.wav") for i in range(8)]
            for i, path in enumerate(paths):
                # Scaled 1 % apart, so no two files are the same.
                overlap_wav(path, 5, 1.0 + 0.01 * i)
            file_s = read_wav(paths[0])[0].shape[1] / SR
            audio_s = file_s * len(paths)
            t0 = time.perf_counter()
            eng = overlap_engine()
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

            def counted_separate(audio):
                """Counts the call and its rows, and takes its own peak
                device memory (the pass's peak so far is kept first)."""
                calls["separate_batch"] = calls.get("separate_batch", 0) + 1
                sep_rows.append((len(audio), _row_bucket(len(audio)),
                                 int(np.shape(audio)[1])))
                peaks["pass"] = max(peaks["pass"],
                                    torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
                out = separate(audio)
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
        path = os.path.join(tmp, "overlap_24s.wav")
        overlap_wav(path, 2)
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

            def counted(audio, _f=separate):
                n_sep[0] += 1
                return _f(audio)
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
            wav = os.path.join(tmp, "meeting.wav")
            overlap_wav(wav, 2)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one main-path call, one engine pass and "
                         "one overlap pass with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = nvidia_smi()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    gen = torch.Generator(device="cuda").manual_seed(0)

    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {phase_s[name]:.1f} s")
        return out

    build_s, sass = timed("build", phase_build)
    rows, kernel_extra = timed("kernels", phase_kernels, gen)
    slice_res = timed("slice", phase_slice)
    calls, launches, breakdown = timed("main", phase_main, args.profile)
    for r in rows:
        r["launches"] = launches[r["name"]]
    engine = timed("engine", phase_engine, args.profile)
    parity = timed("engine_parity", phase_engine_parity)
    overlap, overlap_eng = timed("overlap", phase_overlap, args.profile)
    overlap_parity = timed("overlap_parity", phase_overlap_parity)
    serve = timed("serve", phase_serve, overlap_eng)
    for r in rows:
        r["launches_by_path"] = {
            "transcription": r["launches"],
            "engine": engine["launches"][r["name"]],
            "overlap_engine": overlap["launches"][r["name"]],
            "word_timestamps": overlap["align"]["launches"][r["name"]],
            "serve": serve["launches"][r["name"]]}

    report = {"card": card, "build_s": build_s, "sass": sass, "kernels": rows,
              "kernel_extra": kernel_extra, "slice": slice_res,
              "main_calls": calls, "breakdown": breakdown, "engine": engine,
              "engine_parity": parity, "overlap": overlap,
              "overlap_parity": overlap_parity, "serve": serve,
              "phase_s": phase_s, "total_s": time.perf_counter() - t_start}
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
