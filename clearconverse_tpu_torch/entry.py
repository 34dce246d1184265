"""The port's counterpart of the root ``__graft_entry__.entry()``.

``entry()`` returns ``(forward, (model, mel, tokens))``: ``forward`` is one
full teacher-forced pass of Whisper — the encoder (kernel K2 on the card),
the cross-attention K/V and a causal prefill of the 21 prompt tokens — and
the arguments are a seeded model, one 30 s log-mel window from a numpy seed
and the token prompt of the JAX entry. The defaults are the JAX entry's:
small.en dims in bf16, on the card; ``dims``, ``dtype`` and ``device`` let a
test run it small, at f32, on the CPU.

``dryrun_multichip(n)`` is the counterpart of the JAX file's dry run over a
(data, model) mesh of ``n`` ranks (``model = 2`` when ``n`` is even): one
sharded train step, a sharded ``transcribe_batch`` and the engine's
``process_files`` on two synthetic conversations, each held equal to the
1×1 result computed in the calling process. Its ranks are spawned
processes (``parallel/launch.run_group``): CPU ranks over gloo with
``device="cpu"``; on the card, one card per rank when the host has ``n``,
else all ranks on ``cuda:0`` (over gloo).
"""

from __future__ import annotations

import numpy as np
import torch


def entry(dims=None, dtype: torch.dtype = torch.bfloat16, device="cuda"):
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.whisper import (
        WhisperDims, decoder_forward, init_kv_cache, model_dims,
        precompute_cross_kv, whisper_encode)

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    dims: WhisperDims = dims or model_dims("small.en")
    model = init_whisper(dims, 0, device)

    @torch.inference_mode()
    def forward(model, mel: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Encoder + decoder prefill → logits [B, L, n_vocab] f32."""
        audio = whisper_encode(model, mel, dims, dtype)
        cross_kv = precompute_cross_kv(model, audio, dims.n_text_head)
        B, L = tokens.shape
        dev = tokens.device
        kv = init_kv_cache(dims, B, L, dtype, device=dev)
        pos = torch.arange(L, device=dev)[None, :].expand(B, L)
        k = torch.arange(L, device=dev)[None, None, None, :]
        q = torch.arange(L, device=dev)[None, None, :, None]
        causal = torch.where(k <= q, 0.0, -1e9).float()
        logits, _ = decoder_forward(model, tokens, pos, 0, kv, cross_kv,
                                    causal, None, dims, dtype)
        return logits

    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, dims.n_mels, 3000)).astype(np.float32)).to(device)
    tokens = torch.tensor([[50257] + list(range(20))], dtype=torch.long,
                          device=device)
    return forward, (model, mel, tokens)


# Tiny dims of the JAX dry run with 64-wide heads, the only width the
# card's encoder-attention kernel takes: the train step's 4 heads at 256
# wide, serving's and the engine's 2 heads at 128 wide.
_TRAIN_DIMS = dict(n_mels=16, n_vocab=256, n_audio_ctx=32, n_audio_state=256,
                   n_audio_head=4, n_audio_layer=2, n_text_ctx=16,
                   n_text_state=256, n_text_head=4, n_text_layer=2)
_SERVE_DIMS = dict(n_mels=80, n_vocab=51864, n_audio_ctx=1500,
                   n_audio_state=128, n_audio_head=2, n_audio_layer=1,
                   n_text_ctx=448, n_text_state=128, n_text_head=2,
                   n_text_layer=1)
# ECAPA's seed, the JAX dry run's; with two speakers required, its seeded
# embeddings split the two synthetic speakers and overlap is found.
_ECAPA_SEED = 38


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the three mesh checks on ``n_devices`` spawned ranks and hold
    each against 1×1; raises on a mismatch. Returns the train loss, the
    texts and the engine's segments."""
    from clearconverse_tpu_torch.parallel.launch import run_group

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device is available; "
                           "pass device='cpu' to run CPU ranks")
    model = 2 if n_devices % 2 == 0 else 1
    data = n_devices // model
    if dev.type == "cpu":
        devices = ["cpu"] * n_devices
    elif torch.cuda.device_count() >= n_devices:
        devices = [f"cuda:{i}" for i in range(n_devices)]
    else:
        devices = ["cuda:0"] * n_devices
    texts_1x1 = _serving_transcribe(devices[0], 1, 1)
    engine_1x1 = _engine_process_files(devices[0], 1, 1)
    loss, texts_mesh, engine_mesh = run_group(
        _dryrun_rank, devices, args=(data, model))
    if not (np.isfinite(loss) and loss > 0.0):
        raise RuntimeError(f"dryrun_multichip: sharded train loss {loss}")
    if texts_mesh != texts_1x1:
        raise RuntimeError(f"dryrun_multichip: {data}x{model} texts "
                           f"{texts_mesh} != 1x1 {texts_1x1}")
    if engine_mesh != engine_1x1:
        raise RuntimeError(f"dryrun_multichip: {data}x{model} engine "
                           f"{engine_mesh} != 1x1 {engine_1x1}")
    n_overlap = sum(1 for segs in engine_1x1 for seg in segs if seg[3])
    if not any(engine_1x1) or not n_overlap:
        raise RuntimeError("dryrun_multichip: no overlap segment crossed "
                           f"the engine: {engine_1x1}")
    print(f"dryrun_multichip OK: mesh={data}x{model} on {devices[0]} "
          f"loss={loss:.4f} serving texts equal 1x1; engine equal 1x1 "
          f"({sum(len(s) for s in engine_1x1)} segments, {n_overlap} "
          f"overlap)")
    return {"mesh": (data, model), "devices": devices, "loss": loss,
            "texts": texts_mesh, "engine": engine_mesh}


def _dryrun_rank(devices, data: int, model: int):
    """One rank of ``dryrun_multichip``; rank 0 returns (loss, texts,
    engine segments)."""
    import torch.distributed as dist

    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.whisper import WhisperDims
    from clearconverse_tpu_torch.parallel.mesh import build_mesh
    from clearconverse_tpu_torch.parallel.sharding import shard_whisper
    from clearconverse_tpu_torch.train.finetune import (
        init_train_state, make_train_step, trainable_whisper)

    dev = torch.device(devices[dist.get_rank()])
    mesh = build_mesh(data, model, devices)
    dims = WhisperDims(**_TRAIN_DIMS)
    shard = shard_whisper(trainable_whisper(init_whisper(dims, 0, dev)), mesh)
    step = make_train_step(dims, mesh=mesh, compute_dtype=torch.float32)
    B = data * model          # at least one row per data rank
    rng = np.random.default_rng(0)
    batch = {
        "mel": rng.standard_normal((B, 16, 64)).astype(np.float32),
        "tokens": rng.integers(0, 256, (B, 8)),
        "targets": rng.integers(0, 256, (B, 8)),
        "loss_mask": np.ones((B, 8), np.float32)}
    metrics = step(init_train_state(shard),
                   {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
    loss = float(metrics["loss"])
    texts = _serving_transcribe(dev, data, model)
    engine = _engine_process_files(dev, data, model)
    return loss, texts, engine


def _tiny_whisper_bundle(cfg, tc, device):
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.models.whisper import WhisperDims
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle

    dims = WhisperDims(**_SERVE_DIMS)
    model = init_whisper(dims, 0, device)
    # Every token row but the 256 byte ids and EOT shrinks 100x, so the
    # seeded decode emits bytes the byte-fallback tokenizer renders as text.
    with torch.no_grad():
        model.decoder.tok[256:50256] *= 0.01
        model.decoder.tok[50257:] *= 0.01
    bundle = ModelBundle(cfg, tc, device=device)
    bundle._whisper = (model, dims, ByteFallbackTokenizer(english=True))
    bundle._loaded = True
    return bundle


def _serving_transcribe(device, data: int, model: int):
    """One batched decode (t=0) through a ModelBundle on a data × model
    mesh; every rank calls it."""
    from clearconverse_tpu_torch.config import Config, TorchConfig

    bundle = _tiny_whisper_bundle(
        Config(), TorchConfig(max_decode_tokens=8, compute_dtype="float32",
                              data_axis=data, model_axis=model), device)
    rng = np.random.default_rng(7)
    audio = rng.standard_normal((3, 8000)).astype(np.float32) * 0.1
    return bundle.transcribe_batch(audio, ["", "ctx", ""], temperature=0.0)


def _engine_process_files(device, data: int, model: int):
    """``process_files`` on two synthetic conversations with a tiny whole
    bundle (Whisper, ECAPA, RE-SepFormer and the crafted PyanNet) on a
    data × model mesh: rank 0 runs the engine and leads, the other ranks
    follow its calls. Returns rank 0's [(start, end, speaker, is_overlap,
    text)] per file (None on the other ranks). Binarization and the
    clustering threshold are lowered and two speakers are required, so
    that seeded weights find both speakers and their overlap."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from clearconverse_tpu_torch.audio.wav import write_wav
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.models.ecapa import EcapaDims, init_ecapa
    from clearconverse_tpu_torch.models.resepformer import (
        SepformerDims, init_sepformer)
    from clearconverse_tpu_torch.parallel.serve import follow, lead
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        SR, craft_pyannet_freq_params, synth_conversation)
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

    cfg = Config(noise_reduction_amount=0.2, temperature=0.0, min_speakers=2)
    tc = TorchConfig(max_decode_tokens=8, max_fallback_attempts=1,
                     compute_dtype="float32", diarization_onset=0.35,
                     diarization_offset=0.25,
                     diarization_cluster_threshold=0.30, data_axis=data,
                     model_axis=model)
    b = _tiny_whisper_bundle(cfg, tc, device)
    edims = EcapaDims(n_mels=24, channels=32, mfa_channels=48,
                      attention_channels=16, embedding_dim=16,
                      res2net_scale=4)
    b._ecapa, b._ecapa_dims = init_ecapa(edims, _ECAPA_SEED, device), edims
    b._sepformer = init_sepformer(
        SepformerDims(enc_channels=16, d_model=16, n_heads=2, chunk_size=20,
                      n_repeats=1, n_intra_layers=1, n_inter_layers=1),
        2, device)
    b._pyannet, b._pyannet_dims = craft_pyannet_freq_params(device=device)
    if data * model > 1 and dist.get_rank() != 0:
        follow(b)
        return None
    ctl = lead(b) if data * model > 1 else None
    tmp = tempfile.mkdtemp(prefix="cc_dryrun_")
    try:
        base = synth_conversation()
        paths = []
        for i in range(2):
            paths.append(os.path.join(tmp, f"conv_{i}.wav"))
            write_wav(paths[-1], base * (1.0 - 0.05 * i), SR)
        results = TranscriptionEngine(cfg, tc, models=b,
                                      device=device).process_files(paths)
    finally:
        if ctl is not None:
            ctl.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [[(round(s.start, 3), round(s.end, 3), s.speaker_id,
              bool(s.is_overlap), s.transcription or "")
             for s in ((r or {}).get("segments") or [])] for r in results]

