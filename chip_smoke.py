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
Then it prints the kernels JSON line, the card's name and power limit, and,
last, {"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.

Run from the repository root:  python3 chip_smoke.py [--profile]
(--profile also traces one transcribe_batch call and one engine pass with
torch.profiler: kernel time by name and the card's busy share.)
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
    cpu_whisper = init_whisper(dims, seed=1, device="cpu")
    # Every row of the token table but the 256 byte ids and EOT shrinks
    # 100x, so the decode emits bytes the byte-fallback tokenizer renders
    # as text, and the no-speech gate (which would blank it) stays shut.
    with torch.no_grad():
        cpu_whisper.decoder.tok[256:50256] *= 0.01
        cpu_whisper.decoder.tok[50257:] *= 0.01
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one main-path call and one engine pass "
                         "with torch.profiler")
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

    report = {"card": card, "build_s": build_s, "sass": sass, "kernels": rows,
              "kernel_extra": kernel_extra, "slice": slice_res,
              "main_calls": calls, "breakdown": breakdown, "engine": engine,
              "engine_parity": parity, "phase_s": phase_s,
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
