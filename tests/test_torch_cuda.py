"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, the wrappers' input checks, a tiny transcription (and an int4
cross-KV decode) on the card against the same on the CPU, the speaker and
separation models card vs CPU, a tiny dress-rehearsal round trip on the card,
the bench's hot-path line, int8 decoder weights card vs CPU, two mesh
ranks sharing the card, two model-sharded ranks with a card each decoding
through CUDA graphs over NCCL, and the token loop as CUDA graphs (greedy,
sampling and beam search) against the eager loop. Every test needs a CUDA
card and skips without one (the NCCL test without two). The lossless audio
wire on the card is held to the packed wire's gate on the same batch.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without JAX. tests/conftest.py imports JAX, so there run it as:
    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from clearconverse_tpu_torch.audio import mel as tmel
from clearconverse_tpu_torch.ops import encoder_attention as k2
from clearconverse_tpu_torch.ops import logmel as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32) * scale)


def _k1_against_plain(a, n_mels=80):
    """Mel power rtol 2e-3 / atol 1e-6, log-mel atol 5e-4."""
    before = k1.mel_power.launches
    power = k1.mel_power(a, n_mels)
    torch.cuda.synchronize()
    assert k1.mel_power.launches == before + 1
    assert power.shape == (a.shape[0], a.shape[1] // 160, n_mels)
    ref = k1.mel_power_plain(a, n_mels)
    np.testing.assert_allclose(power.cpu().numpy(), ref.cpu().numpy(),
                               rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(
        tmel.log_mel_from_power(power).cpu().numpy(),
        tmel.log_mel_spectrogram(a, n_mels).cpu().numpy(), atol=5e-4)


def _speech_then_silence(batch, t, seed):
    """Voiced, syllable-modulated harmonics for the first 40 % of each row,
    digital silence after."""
    rng = np.random.default_rng(seed)
    n = int(0.4 * t)
    tt = np.arange(n) / 16000
    out = np.zeros((batch, t), np.float32)
    for row in out:
        f0 = 110 + 40 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * tt)
        phase = 2 * np.pi * np.cumsum(f0) / 16000
        voiced = sum(np.sin(h * phase) / h for h in range(1, 12))
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3, 5) * tt)) ** 2
        sig = voiced * env + 0.02 * rng.standard_normal(n)
        row[:n] = 0.3 * sig / np.abs(sig).max()
    return torch.from_numpy(out)


@pytest.mark.parametrize("t", [480000, 33600])   # 30 s; 210 frames
def test_k1_matches_plain(cuda, t):
    """Mel power rtol 2e-3 / atol 1e-6, log-mel atol 5e-4."""
    _k1_against_plain(_randn((2, t), 0, 0.2).to(cuda))


# The tensor-core kernel at the main path's 30 s rows, B up to the engine's
# transcription batch of 32, and at frame counts around its 192-frame tile
# (the last tile is ragged; the wrapper refuses T <= 200).
@pytest.mark.parametrize("batch,n_frames", [
    (1, 3000), (8, 3000), (32, 3000),
    (2, 2), (2, 191), (2, 192), (2, 193), (2, 385)])
def test_k1_tiles_match_plain(cuda, batch, n_frames):
    _k1_against_plain(_randn((batch, 160 * n_frames), 8, 0.1).to(cuda))


@pytest.mark.parametrize("batch,t", [(8, 480000), (2, 33600)])
def test_k1_speech_with_silence_matches_plain(cuda, batch, t):
    """Speech then digital silence: quiet bins near the clamp floor."""
    _k1_against_plain(_speech_then_silence(batch, t, 9).to(cuda))


@pytest.mark.parametrize("n_mels", [128, 77])
def test_k1_other_mel_counts_match_plain(cuda, n_mels):
    """128 mels (large-v3) take the m64n128 instance; 77 pads to 80."""
    _k1_against_plain(_randn((2, 33600), 10, 0.1).to(cuda), n_mels)


def test_k1_rejects_what_it_cannot_take(cuda):
    with pytest.raises(ValueError):
        k1.mel_power(torch.zeros((1, 16001), device=cuda))        # not a hop multiple
    with pytest.raises(ValueError):
        k1.mel_power(torch.zeros((1, 16000), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        k1.mel_power(torch.zeros((1, 160), device=cuda))          # T <= 200
    m = torch.zeros(16000 + 1, device=cuda)[1:].view(1, 16000)    # misaligned
    assert m.is_contiguous() and m.data_ptr() % 16
    with pytest.raises(ValueError):
        k1.mel_power(m)


def test_k1_refuses_operands_of_another_layout(cuda):
    """The kernel holds the operand buffer's size against its own Shape: a
    buffer one stage short, or as long as the unfolded layout, is refused
    with cudaErrorInvalidValue (1) before any launch."""
    a = _randn((1, 16000), 0, 0.1).to(cuda)
    out = torch.empty((1, 100, 80), device=cuda)
    ops = k1.device_operands(a.device, 80)
    stream = torch.cuda.current_stream().cuda_stream

    def rc(n_bytes):
        return k1._lib().cc_mel_power(a.data_ptr(), 1, 16000, ops.data_ptr(),
                                      n_bytes, 80, out.data_ptr(), stream)

    assert rc(ops.numel() * 4 - k1.tile_shape(80).stage_bytes) == 1
    assert rc(k1.kernel_operands(80, folded=False).nbytes) == 1
    assert rc(ops.numel() * 4) == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape,n_head", [((2, 1500, 768), 12), ((2, 300, 256), 4)])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_k2_matches_plain(cuda, shape, n_head, dtype, atol):
    """q, k ~ N(0, 1), v ~ 0.3 N(0, 1); f32 atol 1e-4, bf16 atol 2e-3."""
    q, k, v = (_randn(shape, seed, scale).to(cuda, getattr(torch, dtype))
               for seed, scale in ((1, 1.0), (2, 1.0), (3, 0.3)))
    before = k2.encoder_attention.launches
    out = k2.encoder_attention(q, k, v, n_head)
    torch.cuda.synchronize()
    assert k2.encoder_attention.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = k2.encoder_attention_plain(q, k, v, n_head)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol)


def _k2_against_plain(q, k, v, n_head, atol):
    before = k2.encoder_attention.launches
    out = k2.encoder_attention(q, k, v, n_head)
    torch.cuda.synchronize()
    assert k2.encoder_attention.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = k2.encoder_attention_plain(q, k, v, n_head)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=atol)


# The bf16 kernel (wgmma + TMA) at the encoder's shape, B up to the engine's
# transcription batch of 32, and at ragged T around its 128-key and
# 192-query tiles: TMA zero-fills rows >= T and the kernel masks the last
# key tile and the last query tile's stores.
@pytest.mark.parametrize("batch,t_len,n_head", [
    (1, 1500, 12), (8, 1500, 12), (32, 1500, 12),
    (2, 1, 2), (2, 65, 2), (2, 127, 2), (2, 128, 2), (2, 129, 2),
    (2, 193, 2), (2, 300, 2)])
def test_k2_bf16_matches_plain(cuda, batch, t_len, n_head):
    """bf16, q, k ~ N(0, 1), v ~ 0.3 N(0, 1); atol 2e-3: the outputs stay
    below 0.5, where one bf16 step is 2^-9, so kernel and plain version may
    round an output one step apart."""
    shape = (batch, t_len, 64 * n_head)
    q, k, v = (_randn(shape, seed, scale).to(cuda, torch.bfloat16)
               for seed, scale in ((5, 1.0), (6, 1.0), (7, 0.3)))
    _k2_against_plain(q, k, v, n_head, 2e-3)


def test_k2_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((1, 10, 256), device=cuda)
    with pytest.raises(ValueError):
        k2.encoder_attention(q, q, q, 8)                     # 32-wide heads
    with pytest.raises(ValueError):
        t = torch.zeros((1, 256, 10), device=cuda).transpose(1, 2)
        k2.encoder_attention(t, t, t, 4)                     # not contiguous
    with pytest.raises(ValueError):
        h = q.half()
        k2.encoder_attention(h, h, h, 4)                     # fp16
    for dtype in (torch.bfloat16, torch.float32):            # misaligned
        m = torch.zeros(10 * 256 + 1, device=cuda, dtype=dtype)[1:]
        m = m.view(1, 10, 256)
        assert m.is_contiguous() and m.data_ptr() % 16
        with pytest.raises(ValueError):
            k2.encoder_attention(m, m, m, 4)


def test_tiny_transcription_card_matches_cpu(cuda):
    """f32, 64-wide heads so K2 runs: identical texts and decode tokens on
    the card and the CPU, and both kernels launched on the card."""
    from clearconverse_tpu_torch.config import TorchConfig
    from clearconverse_tpu_torch.models import decoding
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.models.whisper import WhisperDims
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle

    dims = WhisperDims(n_audio_state=128, n_audio_head=2, n_audio_layer=1,
                       n_text_state=128, n_text_head=2, n_text_layer=1)
    audio = _randn((2, 16000), 4, 0.1).numpy()
    toks, lens = decoding.build_prompt_batch([[50257, 50362]] * 2, 4, 50256)
    opts = decoding.DecodeOptions(max_tokens=8, suppress_tokens=tuple(
        range(50257, 51864)), no_speech_token=50361)
    results = {}
    counts = (k1.mel_power.launches, k2.encoder_attention.launches)
    for dev in (cuda, torch.device("cpu")):
        model = init_whisper(dims, seed=0, device="cpu").to(dev)
        b = ModelBundle(torch_config=TorchConfig(compute_dtype="float32",
                                                 cross_kv_bits=16,
                                                 max_decode_tokens=8),
                        device=dev)
        b._whisper = (model, dims, ByteFallbackTokenizer())
        b._loaded = True
        texts = b.transcribe_batch(audio, ["", "p"], temperature=0.0)
        out = decoding.greedy_decode_from_audio(
            model, torch.from_numpy(audio).to(dev),
            torch.from_numpy(toks).to(dev), torch.from_numpy(lens).to(dev),
            dims, opts, 4)
        results[dev.type] = (texts, out["tokens"].cpu())
    assert results["cuda"][0] == results["cpu"][0]
    assert torch.equal(results["cuda"][1], results["cpu"][1])
    assert k1.mel_power.launches > counts[0]
    assert k2.encoder_attention.launches > counts[1]


# ------------------------------------------- the engine's default pass

def _speaker_bundle(dev):
    """Full-width ECAPA and PyanNet from fixed seeds (the same numbers on
    every device), the gate's tolerances below are the CPU parity tests'."""
    from clearconverse_tpu_torch.models.ecapa import EcapaDims, init_ecapa
    from clearconverse_tpu_torch.models.pyannet import PyannetDims, init_pyannet
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    b = ModelBundle(device=dev)
    b._ecapa, b._ecapa_dims = init_ecapa(EcapaDims(), 2, dev), EcapaDims()
    b._pyannet, b._pyannet_dims = init_pyannet(PyannetDims(), 3, dev), \
        PyannetDims()
    b._loaded = True
    return b


def test_gate_on_card_matches_cpu(cuda):
    """The int16 gate (spectral gate + normalize) on the card against the
    CPU on the same int16 batch: within 2e-5, int16 download within one
    step."""
    from clearconverse_tpu_torch.audio import denoise
    rng = np.random.default_rng(11)
    t = np.arange(3 * 16000) / 16000
    q = np.zeros((2, t.size), np.int16)
    for row, f in enumerate((180.0, 260.0)):
        q[row] = np.round(9000 * np.sin(2 * np.pi * f * t)
                          + rng.standard_normal(t.size) * 200)
    n_valid = np.array([t.size, 30000], np.int32)
    q[1, 30000:] = 0
    out = []
    for dev in (cuda, torch.device("cpu")):
        y, qo = denoise.gate_normalize_i16(
            torch.from_numpy(q).to(dev), 0.5,
            torch.from_numpy(n_valid).to(dev))
        out.append((y.cpu().numpy(), qo.cpu().numpy().astype(np.int32)))
    (y_card, q_card), (y_cpu, q_cpu) = out
    np.testing.assert_allclose(y_card, y_cpu, atol=2e-5)
    assert np.abs(q_card - q_cpu).max() <= 1


def test_lossless_wire_on_card_sends_staged_int16(cuda, tmp_path):
    """On the card the wire sends the staged int16 batch raw: every row read
    straight into the page-locked staging batch; a gated batch and int16
    download equal to gate_normalize_i16 of the same batch on the card, bit
    for bit; a second call that reuses the pinned buffer; and, without the
    spectral gate, a batch within 2e-5 (download within one int16 step) of
    gate_normalize_i16 of that batch on the CPU."""
    from clearconverse_tpu_torch.audio import decode, denoise, wav
    rng = np.random.default_rng(3)
    paths, waves = [], []
    for k, n in enumerate((480000, 336000, 479667)):
        t = np.arange(n) / 16000
        x = (0.3 * np.sin(2 * np.pi * (160 + 40 * k) * t)
             + rng.standard_normal(n) * 0.002).astype(np.float32)
        paths.append(str(tmp_path / f"f{k}.wav"))
        wav.write_wav(paths[-1], x, 16000)
        waves.append(wav.read_wav_i16(paths[-1])[0])
    n_valid = np.array([len(w) for w in waves], np.int32)
    q = np.zeros((len(waves), 480000), np.int16)
    for row, w in enumerate(waves):
        q[row, : len(w)] = w
    y, qo = denoise.gate_normalize_i16(
        torch.from_numpy(q).to(cuda), 0.2, torch.from_numpy(n_valid).to(cuda))
    want = qo.cpu().numpy().astype(np.float32) / 32767.0
    for call in range(2):
        info = {}
        h, b, m = decode.load_audio_many(
            paths, noise_reduction_amount=0.2, return_device=True,
            wire_info=info, staging_info=info, device=cuda)
        assert info["format"] == "int16" and info["width"] == 16
        assert info["rows_direct"] == len(paths)
        assert info["rows_converted"] == 0
        assert m == [0, 1, 2] and torch.equal(b, y)
        for row in range(len(paths)):
            np.testing.assert_array_equal(h[row], want[row, : n_valid[row]])
        assert decode._STAGING.flat.is_pinned()
    assert info["staging_reused"] == 1
    # The spectral gate's decisions on pure tones sit within f32 rounding of
    # its threshold on some bins, so card and CPU are compared without it.
    y_cpu, qo_cpu = denoise.gate_normalize_i16(
        torch.from_numpy(q), 0.0, torch.from_numpy(n_valid), denoise=False)
    want_cpu = qo_cpu.numpy().astype(np.float32) / 32767.0
    h, b, _ = decode.load_audio_many(paths, noise_reduction_amount=0.0,
                                     return_device=True, device=cuda)
    np.testing.assert_allclose(b.cpu().numpy(), y_cpu.numpy(), atol=2e-5)
    for row in range(len(paths)):
        np.testing.assert_allclose(h[row], want_cpu[row, : n_valid[row]],
                                   atol=1.01 / 32767.0)


def test_store_embeddings_equal_host_on_card(cuda):
    """Full-width ECAPA on the card: embed_store, embed_frames_store and
    embed_denoised_store equal their host versions (tests/test_store.py's
    rtol 1e-5 / atol 1e-6), and the card agrees with the CPU within 1e-4."""
    rng = np.random.default_rng(12)
    files = [rng.standard_normal(6 * 16000).astype(np.float32) * 0.1,
             rng.standard_normal(5 * 16000).astype(np.float32) * 0.1]
    rows, starts, lens = [0, 1, 1], [1000, 0, 30000], [16000, 12000, 7000]
    host = np.zeros((3, 16000), np.float32)
    for k, (r, s, n) in enumerate(zip(rows, starts, lens)):
        host[k, :n] = files[r][s: s + n]
    fr, pad = 270, 3 * 16000
    fstarts = np.zeros((1, -(-pad // fr)), np.int32)
    fstarts[0, :10] = np.arange(0, 40, 4) * fr
    clip = np.concatenate([files[0][s: s + fr] for s in fstarts[0, :10]])
    fhost = np.zeros((1, pad), np.float32)
    fhost[0, : clip.size] = clip
    embs = []
    for dev in (cuda, torch.device("cpu")):
        b = _speaker_bundle(dev)
        batch = np.zeros((2, files[0].size), np.float32)
        batch[1, : files[1].size] = files[1]
        batch[0] = files[0]
        store = b.make_store(batch, 16000)
        kw = dict(rtol=1e-5, atol=1e-6)
        e = b.embed_store(store, rows, starts, lens, 16000)
        np.testing.assert_allclose(e, b.embed_batch(host, np.array(lens)), **kw)
        d, var = b.embed_denoised_store(store, rows, starts, lens, 0.5, 16000,
                                        with_var=True)
        np.testing.assert_allclose(
            d, b.embed_denoised_batch(host, np.array(lens), 0.5), **kw)
        f = b.embed_frames_store(store, [0], fstarts, [clip.size], fr, pad)
        np.testing.assert_allclose(f, b.embed_batch(fhost, [clip.size]), **kw)
        s = b.segment_frames_store(store, [0, 1], [0, 0], 5 * 16000)
        embs.append((e, d, f, var, s))
    for a, c in zip(*embs):
        np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-4)


def test_separate_batch_on_card_matches_cpu(cuda):
    """Full-width RE-SepFormer (SepformerDims(), seeded) through
    ModelBundle.separate_batch on the card and on the CPU, three rows padded
    to four at the 5 s bucket: tests/test_speaker_golden.py's rtol 1e-3 /
    atol 1e-4."""
    from clearconverse_tpu_torch.config import TorchConfig
    from clearconverse_tpu_torch.models.resepformer import (
        SepformerDims, init_sepformer)
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle

    rng = np.random.default_rng(13)
    t = np.arange(5 * 16000) / 16000
    mix = np.stack([0.4 * np.sin(2 * np.pi * f0 * t)
                    + 0.3 * np.sin(2 * np.pi * f1 * t)
                    + 0.02 * rng.standard_normal(t.size)
                    for f0, f1 in ((300, 2000), (180, 900), (250, 1500))])
    mix[2, 3 * 16000:] = 0.0
    outs = []
    for dev in (cuda, torch.device("cpu")):
        b = ModelBundle(torch_config=TorchConfig(), device=dev)
        b._sepformer = init_sepformer(SepformerDims(), seed=1, device=dev)
        b._loaded = True
        out = b.separate_batch(mix.astype(np.float32))
        assert out.shape == (3, 5 * 16000, 2) and out.dtype == np.float32
        assert np.isfinite(out).all()
        outs.append(out)
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-3, atol=1e-4)


def test_published_resepformer_batch_on_card_matches_reference_rows(cuda):
    """The published RE-SepFormer (ResepformerDims(), 7,955,201 weights,
    seeded) through ModelBundle.separate_batch on the card, 16 rows of
    mixed lengths padded to the 10 s bucket, each row against the plain
    float32 reference (benchmark/ccbench/resepformer_reference.py) run on
    that row alone at its own length: every source within 1e-4 of the
    reference's norm (IEEE f32 on both sides; the sums of 8 layers and of
    a different association of products leave about 1e-6)."""
    import importlib.util
    import os
    from clearconverse_tpu_torch.config import TorchConfig
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark", "ccbench",
        "resepformer_reference.py")
    spec = importlib.util.spec_from_file_location("resepformer_reference",
                                                  path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)

    b = ModelBundle(torch_config=TorchConfig(
        separator="resepformer-wsj02mix"), device=cuda)
    b._sepformer = b._load_sepformer()
    b._loaded = True
    d = b._sepformer.dims
    assert sum(p.numel() for p in b._sepformer.parameters()) == 7955201
    rng = np.random.default_rng(29)
    T = 10 * 16000
    lens = np.array([T, 5 * 16000 + 1, 6 * 16000 + 7, 9 * 16000, 5 * 16000 + 9,
                     7 * 16000 + 3, 8 * 16000 - 5, 6 * 16000, 5 * 16000 + 199,
                     9 * 16000 + 1200, 1200 * 8 + 8, 7 * 16000, 8 * 16000,
                     T - 1, 5 * 16000 + 4000, 6 * 16000 + 11])
    t = np.arange(T) / 16000
    mix = np.zeros((16, T), np.float32)
    for i, n in enumerate(lens):
        mix[i, :n] = (0.4 * np.sin(2 * np.pi * rng.uniform(150, 400) * t[:n])
                      + 0.3 * np.sin(2 * np.pi * rng.uniform(900, 2500) * t[:n])
                      + 0.02 * rng.standard_normal(n))
    out = b.separate_batch(mix, lens)
    assert out.shape == (16, T, 2) and np.isfinite(out).all()
    assert b.last_separation["rows"] == 16
    # Every segment-block layer through the attention kernel, every layer
    # of the three blocks through the FFN kernel.
    assert b.last_separation["fused_attn_layers"] == 16
    assert b.last_separation["fused_ffn_layers"] == 24
    w = dict(b._sepformer.named_parameters())
    dims = {"N_encoder_out": d.enc_channels, "out_channels": d.d_model,
            "kernel_size": d.enc_kernel, "kernel_stride": d.enc_stride,
            "num_spks": d.n_sources, "segment_size": d.segment_size,
            "layer": d.n_blocks, "num_layers": d.n_layers, "nhead": d.n_heads,
            "d_ffn": d.d_ffn}
    worst = 0.0
    for i, n in enumerate(lens):
        want = ref.separate_one(w, dims, torch.from_numpy(mix[i, :n]).to(cuda))
        got = torch.from_numpy(out[i, :n]).to(cuda)
        gap = ((got.double() - want.double()).norm(dim=0)
               / want.double().norm(dim=0)).max()
        worst = max(worst, float(gap))
    print(f"published RE-SepFormer, 16 rows on the card: widest source gap "
          f"{worst:.3e}")
    assert worst <= 2e-6


def _sb_rows(seed):
    """Activations of the published separator's shapes from 16 rows of
    mixed lengths (1.2-10 s): the segment blocks' [segments, 150, 128] and
    the memory block's [16, segments of the longest row, 128]."""
    from clearconverse_tpu_torch.models import resepformer as rsf
    d = rsf.ResepformerDims()
    lens = np.linspace(1.2, 10.0, 16) * 16000
    n_seg = rsf.resepformer_segments(lens.astype(np.int64), d)
    s_max = rsf.resepformer_segments([int(lens[-1])], d)
    g = torch.Generator(device="cuda").manual_seed(seed)
    seg = torch.randn((n_seg, d.segment_size, d.d_model), generator=g,
                      device="cuda")
    mem = torch.randn((16, s_max, d.d_model), generator=g, device="cuda")
    return seg, mem


@pytest.mark.parametrize("kernel", ["attention", "ffn"])
def test_separator_kernels_match_plain_at_published_widths(cuda, kernel):
    """Each separator kernel (ops/sb_attention.py, ops/sb_ffn.py) against
    its plain version on a layer of the published RE-SepFormer (seeded), at
    the shapes 16 rows of mixed lengths give: the attention on every
    segment (float32 FMA: within 1e-5 of the output's largest), the FFN on
    the segment rows and on the memory block's (3xTF32: within 3e-6 of the
    sublayer's norm, which float32 rounding in another order leaves at
    about 1e-6; one TF32 product a product leaves 4e-4)."""
    from clearconverse_tpu_torch.models import resepformer as rsf
    from clearconverse_tpu_torch.ops import sb_attention as sba
    from clearconverse_tpu_torch.ops import sb_ffn as sbf
    model = rsf.init_resepformer(rsf.ResepformerDims(), seed=3, device=cuda)
    lyr = model.masknet.model.seg_model[0].mdl.layers[2]
    seg, mem = _sb_rows(11)
    if kernel == "attention":
        att = lyr.self_att.att
        qkv = torch.nn.functional.linear(rsf._sb_layer_norm(seg, lyr.norm1),
                                         att.in_proj_weight, att.in_proj_bias)
        before = sba.seg_attention.launches
        got = sba.seg_attention(qkv, 8)
        want = sba.seg_attention_plain(qkv, 8)
        torch.cuda.synchronize()
        assert sba.seg_attention.launches == before + 1
        err = float((got - want).abs().max())
        print(f"segment attention {tuple(qkv.shape)}: max err {err:.3g}")
        assert err <= 1e-5 * float(want.abs().max())
        return
    fc1, fc2 = lyr.pos_ffn.ffn[0], lyr.pos_ffn.ffn[3]
    p = (lyr.norm2.norm.weight, lyr.norm2.norm.bias, fc1.weight, fc1.bias,
         fc2.weight, fc2.bias)
    for h in (seg, mem):
        before = sbf.sb_ffn.launches
        got = sbf.sb_ffn(h, *p)
        want = sbf.sb_ffn_plain(h, *p)
        torch.cuda.synchronize()
        assert sbf.sb_ffn.launches == before + 1
        err = float((got - want).norm() / (want - h).norm())
        print(f"fused FFN {tuple(h.shape)}: error {err:.3g} of the sublayer")
        assert err <= 3e-6


def test_separator_ffn_follows_its_weights_on_card(cuda):
    """The FFN kernel's split weights are made again after the weights
    change in place (as the benchmark's weights are written over a built
    separator), and the wrappers refuse what their kernels do not take."""
    from clearconverse_tpu_torch.models import resepformer as rsf
    from clearconverse_tpu_torch.ops import sb_attention as sba
    from clearconverse_tpu_torch.ops import sb_ffn as sbf
    model = rsf.init_resepformer(rsf.ResepformerDims(), seed=4, device=cuda)
    rsf.prepare_kernels(model)
    lyr = model.masknet.model.mem_model[0].mdl.layers[0]
    fc1, fc2 = lyr.pos_ffn.ffn[0], lyr.pos_ffn.ffn[3]
    p = (lyr.norm2.norm.weight, lyr.norm2.norm.bias, fc1.weight, fc1.bias,
         fc2.weight, fc2.bias)
    h = _sb_rows(12)[1]
    first = sbf.sb_ffn(h, *p)
    with torch.no_grad():
        fc1.weight.copy_(fc1.weight.flip(0))
    got = sbf.sb_ffn(h, *p)
    want = sbf.sb_ffn_plain(h, *p)
    assert float((got - first).abs().max()) > 1e-2
    assert float((got - want).norm() / (want - h).norm()) <= 3e-6
    with pytest.raises(ValueError):
        sbf.sb_ffn(h.transpose(0, 1), *p)
    with pytest.raises(ValueError):
        sbf.sb_ffn(h.double(), *p)
    qkv = torch.zeros((2, 150, 384), device=cuda)
    with pytest.raises(ValueError):
        sba.seg_attention(qkv[:, :, :192], 8)
    with pytest.raises(ValueError):
        sba.seg_attention(torch.zeros((1, 257, 384), device=cuda), 8)


# ---------------------------- int4 cross-KV, dress rehearsal, the bench

def test_int4_cross_kv_card_matches_cpu(cuda):
    """f32, t=0, cross_kv_bits=4, 64-wide heads so K2 runs: identical decode
    tokens on the card and the CPU."""
    from clearconverse_tpu_torch.models import decoding
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.whisper import WhisperDims

    dims = WhisperDims(n_audio_state=128, n_audio_head=2, n_audio_layer=1,
                       n_text_state=128, n_text_head=2, n_text_layer=2)
    audio = _randn((3, 24000), 5, 0.1)
    toks, lens = decoding.build_prompt_batch(
        [[50257, 50362], [50360, 7, 50257, 50362], [50257, 50362]], 4, 50256)
    opts = decoding.DecodeOptions(max_tokens=10, suppress_tokens=tuple(
        range(50257, 51864)), no_speech_token=50361, cross_kv_bits=4)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = init_whisper(dims, seed=3, device="cpu").to(dev)
        res = decoding.greedy_decode_from_audio(
            model, audio.to(dev), torch.from_numpy(toks).to(dev),
            torch.from_numpy(lens).to(dev), dims, opts, 4)
        out[dev.type] = (res["tokens"].cpu(), res["lengths"].cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])


def test_dress_rehearsal_round_trip_on_card(cuda, tmp_path):
    """populate(tiny, device="cuda") → a cold ModelBundle on the card loads
    every family as checkpoint, and the Whisper it loads equals the
    fp16-rounded module that was written."""
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.eval import dress_rehearsal
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle

    dress_rehearsal.populate(str(tmp_path), tiny=True, seed=5, device="cuda")
    b = ModelBundle(Config(), TorchConfig(compute_dtype="float32"),
                    model_dir=str(tmp_path), device=cuda)
    assert b.load_with_progress()
    assert b.load_source == {"whisper": "checkpoint",
                             "tokenizer": "BPETokenizer",
                             "ecapa": "checkpoint", "pyannet": "checkpoint",
                             "sepformer": "checkpoint"}
    model, dims, _ = b._whisper
    written = init_whisper(dims, 5, cuda)
    got = dict(model.named_parameters())
    for name, p in written.named_parameters():
        assert got[name].is_cuda
        assert torch.equal(got[name], p.detach().half().float()), name


def test_bench_hot_path_line_on_card(cuda, capsys):
    """``bench --skip-engine`` at B=2: one JSON line, K1 and K2 launched,
    a step time and a peak memory, and the card's name and power limit."""
    import json

    from clearconverse_tpu_torch import bench

    assert bench.main(["--model", "tiny.en", "--batch", "2",
                       "--decode-tokens", "4", "--iters", "1",
                       "--skip-engine"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and len(lines[0]) < 2000
    line = json.loads(lines[0])
    hot = line["hot_path"]
    assert line["value"] > 0 and "," in line["card"]
    assert hot["launches"]["k1"] > 0 and hot["launches"]["k2"] > 0
    assert hot["step_ms"] > 0 and hot["peak_mem_gb"] > 0


# ------------------------------------- fine-tuning, beam search, overlays

@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-3),
                                        (torch.bfloat16, 3e-2)])
def test_k2_gradient_on_card_matches_cpu(cuda, dtype, rtol):
    """A CUDA K2 output carries the autograd Function's backward (the plain
    attention recomputed): q, k and v gradients against the CPU's within
    ``rtol`` of the largest gradient; one kernel launch per forward, none
    in the backward."""
    q, k, v = (_randn((2, 1500, 128), s, sc) for s, sc in
               ((20, 1.0), (21, 1.0), (22, 0.3)))
    w = _randn((2, 1500, 128), 23)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        ins = [x.to(dev, dtype).requires_grad_(True) for x in (q, k, v)]
        before = k2.encoder_attention.launches
        out = k2.encoder_attention(*ins, 2)
        assert out.grad_fn is not None
        (out.float() * w.to(dev)).sum().backward()
        if dev.type == "cuda":
            assert k2.encoder_attention.launches == before + 1
        grads[dev.type] = [x.grad.float().cpu() for x in ins]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= rtol * float(b.abs().max())


def _train_dims():
    from clearconverse_tpu_torch.models.whisper import WhisperDims
    return WhisperDims(n_audio_state=128, n_audio_head=2, n_audio_layer=1,
                       n_text_state=128, n_text_head=2, n_text_layer=1)


def _train_batch(dev, b=2, L=12):
    rng = np.random.default_rng(30)
    tokens = rng.integers(0, 50256, (b, L))
    mask = np.ones((b, L), np.float32)
    mask[1, 8:] = 0.0
    return {"mel": _randn((b, 80, 3000), 31).to(dev),
            "tokens": torch.from_numpy(tokens).to(dev),
            "targets": torch.from_numpy(np.roll(tokens, -1, 1)).to(dev),
            "loss_mask": torch.from_numpy(mask).to(dev)}


def test_train_step_on_card_matches_cpu(cuda):
    """f32 loss sums within 1e-4 relative; every gradient the CPU finds
    nonzero is nonzero on the card (a K2 output without a backward would
    leave the encoder's q/k/v weights at zero) and within 1e-3 of the
    largest; one AdamW step's update (parameters after minus before) is
    within 5e-6 of the CPU's wherever the CPU gradient exceeds 1e-3 of its
    parameter's largest (a first AdamW step moves such an entry by about
    lr = 1e-5, so a step left out or of the wrong sign fails)."""
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.train import finetune as ft

    dims = _train_dims()
    res = {}
    before = {n: p.detach().clone() for n, p in ft.trainable_whisper(
        init_whisper(dims, 7, "cpu")).named_parameters()}
    for dev in (cuda, torch.device("cpu")):
        model = ft.trainable_whisper(init_whisper(dims, 7, "cpu").to(dev))
        batch = _train_batch(dev)
        s, _ = ft.whisper_loss_sums(model, batch, dims, torch.float32)
        s.backward()
        grads = {n: p.grad.cpu().clone() for n, p in model.named_parameters()}
        state = ft.init_train_state(model)
        ft.make_train_step(dims, compute_dtype=torch.float32)(state, batch)
        res[dev.type] = (float(s.detach()), grads,
                         {n: p.detach().cpu() for n, p in
                          state.model.named_parameters()})
    (sc, gc, pc), (s0, g0, p0) = res["cuda"], res["cpu"]
    assert abs(sc - s0) <= 1e-4 * abs(s0)
    for name, g in g0.items():
        if float(g.abs().max()) > 0:
            assert float(gc[name].abs().max()) > 0, name
        assert float((gc[name] - g).abs().max()) <= \
            1e-3 * float(g.abs().max()) + 1e-6, name
        sel = g.abs() > 1e-3 * float(g.abs().max())
        if bool(sel.any()):
            update_card = (pc[name] - before[name])[sel]
            update_cpu = (p0[name] - before[name])[sel]
            assert float((update_card - update_cpu).abs().max()) <= 5e-6, name


def test_beam_on_card_matches_cpu(cuda):
    """beam_size 3 at t=0, f32: identical beams and lengths on both."""
    from clearconverse_tpu_torch.models import decoding
    from clearconverse_tpu_torch.models.convert import init_whisper

    dims = _train_dims()
    audio = _randn((2, 16000), 32, 0.1)
    toks, lens = decoding.build_prompt_batch([[50257, 50362]] * 6, 4, 50256)
    opts = decoding.DecodeOptions(max_tokens=8, suppress_tokens=tuple(
        range(50257, 51864)), no_speech_token=50361, replicas=3, beam=True)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = init_whisper(dims, seed=0, device="cpu").to(dev)
        res = decoding.greedy_decode_from_audio(
            model, audio.to(dev), torch.from_numpy(toks).to(dev),
            torch.from_numpy(lens).to(dev), dims, opts, 4)
        out[dev.type] = (res["tokens"].cpu(), res["lengths"].cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])


def test_whisper_ft_overlay_loads_on_card(cuda, tmp_path, caplog):
    """A whisper-ft/model.safetensors overlay written by export_whisper_ft
    loads into a card ModelBundle through the port's own reader: the
    loaded weights equal the written module, with no fallback warning."""
    import dataclasses
    import logging

    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.whisper import model_dims
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    from clearconverse_tpu_torch.train.checkpoint import export_whisper_ft

    dims = dataclasses.replace(model_dims("tiny"), n_audio_layer=1,
                               n_text_layer=1)
    written = init_whisper(dims, 9, cuda)
    export_whisper_ft(written, str(tmp_path))
    b = ModelBundle(Config(whisper_model_size="tiny"),
                    TorchConfig(compute_dtype="float32"),
                    model_dir=str(tmp_path), device=cuda)
    with caplog.at_level(logging.WARNING):
        assert b.load_with_progress()
    assert b.load_source["whisper"] == "checkpoint"
    assert "unreadable" not in caplog.text
    model, got_dims, _ = b._whisper
    assert got_dims == dims
    got = dict(model.named_parameters())
    for name, p in written.named_parameters():
        assert torch.equal(got[name], p), name


def test_quantized_dense_on_card_matches_cpu(cuda):
    """An int8 linear (ops/quantize) on the card against the CPU at f32
    (atol 1e-5), and a tiny int8-decoder greedy decode: identical tokens."""
    from clearconverse_tpu_torch.models import decoding
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.whisper import WhisperDims, dense
    from clearconverse_tpu_torch.ops import quantize as q

    lin = torch.nn.Linear(64, 48)
    qlin = q.QuantizedLinear.from_linear(lin)
    x = _randn((4, 64), 3)
    np.testing.assert_allclose(dense(x.to(cuda), qlin.to(cuda)).cpu().numpy(),
                               dense(x, qlin.cpu()).numpy(), atol=1e-5)
    dims = WhisperDims(n_mels=16, n_vocab=64, n_audio_ctx=25,
                       n_audio_state=128, n_audio_head=2, n_audio_layer=1,
                       n_text_ctx=24, n_text_state=128, n_text_head=2,
                       n_text_layer=2)
    model = q.quantize_whisper_decoder(init_whisper(dims, 0, "cpu"))
    mel = _randn((2, 16, 50), 4, 0.3)
    toks, lens = decoding.build_prompt_batch([[1], [1]], 1, pad_id=0)
    opts = decoding.DecodeOptions(max_tokens=8, eot=63, suppress_blank=False)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        out[dev.type] = decoding.greedy_decode(
            model.to(dev), mel.to(dev), torch.from_numpy(toks).to(dev),
            torch.from_numpy(lens).to(dev), dims, opts, 1)["tokens"].cpu()
    assert torch.equal(out["cuda"], out["cpu"])


def test_two_mesh_ranks_share_the_card(cuda):
    """Two spawned ranks on cuda:0 over gloo: transcribe_batch at 1x2 and
    2x1 gives the 1x1 card texts, with K1 and K2 launching on each rank."""
    import torch_mesh_worker
    from clearconverse_tpu_torch.entry import _serving_transcribe
    from clearconverse_tpu_torch.parallel.launch import run_group

    want = _serving_transcribe("cuda:0", 1, 1)
    got = run_group(torch_mesh_worker.card_pair, ["cuda:0", "cuda:0"],
                    timeout_s=300)
    for mesh, (texts, counts) in got.items():
        assert texts == want, mesh
        assert all(k1n > 0 and k2n > 0 for k1n, k2n in counts), (mesh, counts)


def test_sharded_decode_graphs_over_nccl(cuda):
    """Two ranks with a card each over NCCL at 1x2 (one head a rank): a
    model-sharded rank takes the graph route, and greedy (f32 and bf16),
    beam and best_of calls replay CUDA graphs on both ranks. At t=0 the
    graph route gives the eager loop's packed result and steps, in f32 the
    1x1 tokens too; at t=0.1 one seed gives one result; both ranks decode
    the same bits."""
    import torch_mesh_worker
    from clearconverse_tpu_torch.parallel.launch import run_group

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (one a rank over NCCL)")
    ranks = run_group(torch_mesh_worker.nccl_sharded_graphs,
                      ["cuda:0", "cuda:1"], timeout_s=300)
    for res in ranks:
        assert res["backend"] == "nccl" and res["route"] is True
        assert res["heads"] == 1
        for name, got in res["calls"].items():
            graph, steps = got["graph"]
            assert np.array_equal(graph, got["again"][0]), name
            assert got["again"][1] == steps
            if name != "best_of":
                assert np.array_equal(graph, got["eager"][0]), name
                assert got["eager"][1] == steps, name
            if name.endswith("f32"):
                assert np.array_equal(graph[:, :20], got["single"][0][:, :20])
                assert got["single"][1] == steps, name
            assert got["stats"]["replays"] > 0, name
            assert got["stats"]["arena_allocs"] == 1, name
    for name in ranks[0]["calls"]:
        assert np.array_equal(ranks[0]["calls"][name]["graph"][0],
                              ranks[1]["calls"][name]["graph"][0]), name
        assert ranks[0]["calls"][name]["graph"][1] == \
            ranks[1]["calls"][name]["graph"][1], name


# ------------------------------------------- the token loop as CUDA graphs

def _graph_model(dtype=torch.float32, seed=6):
    """A 2-layer Whisper with 64-wide heads (K2 runs) on the card."""
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.whisper import WhisperDims

    dims = WhisperDims(n_audio_state=128, n_audio_head=2, n_audio_layer=1,
                       n_text_state=128, n_text_head=2, n_text_layer=2)
    return init_whisper(dims, seed=seed, device="cuda", dtype=dtype), dims


def _graph_call(model, dims, rows, seed, eager=False, monkeypatch=None,
                generator=None, **opt_kw):
    """greedy_decode_from_audio on ``rows`` rows of seeded noise with the
    graph route, or with the eager loop when ``eager``."""
    from clearconverse_tpu_torch.models import decoding

    timestamps = opt_kw.get("timestamps", False)
    tail = [50257] if timestamps else [50257, 50362]
    lists = [[50360, 11, 22] + tail, tail, [50360, 7] + tail]
    toks, lens = decoding.build_prompt_batch(
        [lists[i % 3] for i in range(rows * opt_kw.get("replicas", 1))],
        8, 50256)
    kw = dict(max_tokens=20, no_speech_token=50361,
              sot_from_end=1 if timestamps else 2,
              suppress_tokens=tuple(range(50257, 50363 if timestamps
                                          else 51864)))
    if timestamps:
        kw["timestamp_begin"] = 50363
    kw.update(opt_kw)
    opts = decoding.DecodeOptions(**kw)
    audio = _randn((rows, 24000), seed, 0.1).cuda()
    args = (model, audio, torch.from_numpy(toks).cuda(),
            torch.from_numpy(lens).cuda(), dims, opts, 8, generator)
    if eager:
        with monkeypatch.context() as m:
            m.setattr(decoding, "_graph_route", lambda model, dev: False)
            return decoding.greedy_decode_from_audio(*args, target_len=32000)
    return decoding.greedy_decode_from_audio(*args, target_len=32000)


def _same_decode(a, b):
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["packed"], b["packed"])
    assert a["steps"] == b["steps"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_graph_matches_eager_on_card(cuda, monkeypatch, dtype):
    """t=0, timestamps on: the graph route gives the eager loop's tokens,
    packed result and step count exactly; it replays, and it reads the stop
    flag at most ceil(steps / K) + 1 times."""
    from clearconverse_tpu_torch.models import decode_graph

    model, dims = _graph_model(dtype)
    graphs = decode_graph.graphs_for(model)
    eager = _graph_call(model, dims, 3, 7, eager=True,
                        monkeypatch=monkeypatch, timestamps=True,
                        compute_dtype=dtype)
    before = dict(graphs.stats)
    graph = _graph_call(model, dims, 3, 7, timestamps=True,
                        compute_dtype=dtype)
    _same_decode(graph, eager)
    assert graphs.stats["captures"] == before["captures"] + 1
    reads = graphs.stats["flag_reads"] - before["flag_reads"]
    assert reads <= -(-graph["steps"] // decode_graph.K) + 1
    if graph["steps"] > 2 * decode_graph.K:
        assert graphs.stats["replays"] > before["replays"]


def test_decode_graph_replays_new_audio_without_recapture(cuda, monkeypatch):
    """A second call of the same bucket with other audio replays the
    captured graph (no capture) and gives the eager result for that audio;
    an int8 self-KV cache and int4 cross-KV go through the same arena."""
    from clearconverse_tpu_torch.models import decode_graph

    model, dims = _graph_model()
    graphs = decode_graph.graphs_for(model)
    kw = dict(self_kv_bits=8, cross_kv_bits=4, eot=-1)
    _graph_call(model, dims, 4, 8, **kw)
    before = dict(graphs.stats)
    graph = _graph_call(model, dims, 4, 9, **kw)
    assert graphs.stats["captures"] == before["captures"]
    assert graphs.stats["replays"] - before["replays"] == \
        -(-(20 - 1) // decode_graph.K)      # eot=-1: every step runs
    _same_decode(graph, _graph_call(model, dims, 4, 9, eager=True,
                                    monkeypatch=monkeypatch, **kw))


def test_two_row_buckets_share_the_arena(cuda, monkeypatch):
    """Buckets of 4 and 2 rows, largest first, replayed in turns: two
    captures, one arena, and every call equals the eager loop; the model
    is freed once its caller drops it (its graphs hold no reference)."""
    from clearconverse_tpu_torch.models import decode_graph

    model, dims = _graph_model()
    graphs = decode_graph.graphs_for(model)
    seeds = iter(range(20, 40))
    for rows in (4, 2, 4, 2, 4):
        seed = next(seeds)
        _same_decode(_graph_call(model, dims, rows, seed),
                     _graph_call(model, dims, rows, seed, eager=True,
                                 monkeypatch=monkeypatch))
    assert graphs.stats["captures"] == 2 and graphs.graphs == 2
    assert graphs.stats["arena_allocs"] == 1
    assert graphs.stats["replays"] > 0
    # The graphs and their arena are dropped with the model.
    import gc
    import weakref
    alive = weakref.ref(model)
    del model, graphs
    gc.collect()
    assert alive() is None


def test_decode_graph_sampling_is_seeded(cuda, monkeypatch):
    """t=0.1 with best_of 5 replicas: the same seed gives the same tokens
    on the graph route, another seed other tokens; whether they equal the
    eager loop's (the same Philox stream) is reported, not required."""
    model, dims = _graph_model()

    def run(seed, eager=False, temperature=0.1):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return _graph_call(model, dims, 2, 11, eager=eager,
                           monkeypatch=monkeypatch, generator=gen,
                           temperature=temperature, replicas=5)

    a = run(3)
    _same_decode(a, run(3))
    # At t=1 the noise decides: other seeds give other tokens.
    assert torch.equal(run(3, temperature=1.0)["tokens"],
                       run(3, temperature=1.0)["tokens"])
    assert not torch.equal(run(3, temperature=1.0)["tokens"],
                           run(4, temperature=1.0)["tokens"])
    same_as_eager = torch.equal(a["tokens"], run(3, eager=True)["tokens"])
    print(f"t=0.1 graph tokens equal the eager loop's: {same_as_eager}")


def test_failing_capture_raises(cuda):
    """A step that reads a value back to the host cannot be captured: the
    decode raises (in a child process, since a failed capture may leave the
    allocator's capture state behind) instead of falling back to the eager
    loop."""
    import os
    import subprocess
    import sys

    code = """
import torch
from clearconverse_tpu_torch.models import decoding
import test_torch_cuda as t
orig = decoding._greedy_step
def syncing(s, c):
    orig(s, c)
    float(s.slp[0])
decoding._greedy_step = syncing
model, dims = t._graph_model()
try:
    t._graph_call(model, dims, 2, 5, eot=-1)
except RuntimeError as exc:
    print("RAISED", "capture failed" in str(exc))
else:
    print("NO ERROR")
"""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, here]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=root)
    assert "RAISED True" in proc.stdout, (proc.stdout, proc.stderr[-3000:])


# ------------------------------------------- beam search as CUDA graphs

def _beam_call(model, dims, rows, seed, eager=False, monkeypatch=None,
               replicas=5, **opt_kw):
    """greedy_decode_from_audio with beam search (``replicas`` beams a row,
    t=0, one prompt per row tiled over its beams) on ``rows`` rows of
    seeded noise, on the graph route or, when ``eager``, the eager one."""
    from clearconverse_tpu_torch.models import decoding

    lists = [[50360, 11, 22, 50257, 50362], [50257, 50362],
             [50360, 7, 50257, 50362]]
    toks, lens = decoding.build_prompt_batch(
        [lists[i % 3] for i in range(rows) for _ in range(replicas)], 8,
        50256)
    kw = dict(max_tokens=20, no_speech_token=50361, replicas=replicas,
              beam=True, suppress_tokens=tuple(range(50257, 51864)))
    kw.update(opt_kw)
    opts = decoding.DecodeOptions(**kw)
    audio = _randn((rows, 24000), seed, 0.1).cuda()
    args = (model, audio, torch.from_numpy(toks).cuda(),
            torch.from_numpy(lens).cuda(), dims, opts, 8)
    if eager:
        with monkeypatch.context() as m:
            m.setattr(decoding, "_graph_route", lambda model, dev: False)
            return decoding.greedy_decode_from_audio(*args, target_len=32000)
    return decoding.greedy_decode_from_audio(*args, target_len=32000)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_beam_graph_matches_eager_on_card(cuda, monkeypatch, dtype):
    """beam_size 5 at t=0: the graph route gives the eager beam loop's
    packed result (tokens, lengths, scores) and step count exactly, replays
    its graph and reads the stop flag at most ceil(steps / K) + 1 times; a
    second call of the same key with other audio captures nothing and
    equals the eager loop for that audio."""
    from clearconverse_tpu_torch.models import decode_graph

    model, dims = _graph_model(dtype)
    graphs = decode_graph.graphs_for(model)
    kw = dict(compute_dtype=dtype, monkeypatch=monkeypatch)
    eager = _beam_call(model, dims, 3, 40, eager=True, **kw)
    before = dict(graphs.stats)
    graph = _beam_call(model, dims, 3, 40, **kw)
    _same_decode(graph, eager)
    assert graphs.stats["captures"] == before["captures"] + 1
    reads = graphs.stats["flag_reads"] - before["flag_reads"]
    assert reads <= -(-graph["steps"] // decode_graph.K) + 1
    before = dict(graphs.stats)
    again = _beam_call(model, dims, 3, 41, **kw)
    assert graphs.stats["captures"] == before["captures"]
    assert graphs.stats["replays"] > before["replays"]
    _same_decode(again, _beam_call(model, dims, 3, 41, eager=True, **kw))


def test_beam_and_greedy_keys_share_the_arena(cuda, monkeypatch):
    """Beam keys (5 beams, int8 self-KV and int4 cross-KV) and a greedy
    key of the same unique rows, largest first, in turns: one capture a
    key, one arena, and every call equals its eager route."""
    from clearconverse_tpu_torch.models import decode_graph

    model, dims = _graph_model()
    graphs = decode_graph.graphs_for(model)
    kw = dict(self_kv_bits=8, cross_kv_bits=4, monkeypatch=monkeypatch)
    for rows, seed in ((4, 50), (2, 51), (4, 52), (2, 53)):
        for call in (_beam_call, _graph_call):
            _same_decode(call(model, dims, rows, seed, **kw),
                         call(model, dims, rows, seed, eager=True, **kw))
    assert graphs.stats["captures"] == 4 and graphs.graphs == 4
    assert graphs.stats["arena_allocs"] == 1
    assert graphs.stats["replays"] > 0


def _warm_engine(dev):
    """An engine for the warm-up on ``dev``: the 2-layer bf16 Whisper of
    the graph tests, seeded ECAPA, the crafted PyanNet (it finds the
    synthetic conversations' speakers, so the engine passes decode) and a
    small seeded RE-SepFormer for their overlap; 4-row decode buckets."""
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.ecapa import EcapaDims, init_ecapa
    from clearconverse_tpu_torch.models.resepformer import (
        SepformerDims, init_sepformer)
    from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
    from clearconverse_tpu_torch.models.whisper import WhisperDims
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        craft_pyannet_freq_params)
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine

    cfg = Config(transcription_batch_size=4)
    tc = TorchConfig(max_decode_tokens=8, diarization_onset=0.35,
                     diarization_offset=0.25,
                     diarization_cluster_threshold=0.30)
    b = ModelBundle(cfg, tc, device=dev)
    dims = WhisperDims(n_audio_state=128, n_audio_head=2, n_audio_layer=1,
                       n_text_state=128, n_text_head=2, n_text_layer=2)
    b._whisper = (init_whisper(dims, seed=6, device=dev,
                               dtype=torch.bfloat16), dims,
                  ByteFallbackTokenizer(english=True))
    b._ecapa, b._ecapa_dims = init_ecapa(EcapaDims(), 2, dev), EcapaDims()
    b._pyannet, b._pyannet_dims = craft_pyannet_freq_params(device=dev)
    sep = SepformerDims(enc_channels=16, d_model=16, n_heads=2,
                        chunk_size=20, n_repeats=1, n_intra_layers=1,
                        n_inter_layers=1)
    b._sepformer, b._sepformer_dims = init_sepformer(sep, 3, dev), sep
    b._loaded = True
    return TranscriptionEngine(cfg, tc, models=b)


def test_warmup_keeps_every_graph_it_captures(cuda):
    """run_warmup drives the decode shapes before the engine passes, so
    the graphs' arena is sized once (``arena_allocs`` 1 after the whole
    warm-up, as its last log line says) and every key an engine pass
    captured is still captured at the end."""
    from clearconverse_tpu_torch.models import decode_graph
    from clearconverse_tpu_torch.serve.warmup import run_warmup

    eng = _warm_engine(cuda)
    graphs = decode_graph.graphs_for(eng.models._whisper[0])
    engine_keys, segments = set(), []
    orig = eng.process_files

    def process_files(paths, *a, **kw):
        before = set(graphs.captured())
        results = orig(paths, *a, **kw)
        segments.append(sum(len(r["segments"]) for r in results if r))
        engine_keys.update(set(graphs.captured()) - before)
        return results
    eng.process_files = process_files
    lines = []
    run_warmup(durations=(30,), file_counts=(1, 2),
               engine_factory=lambda: eng, log=lines.append)
    assert segments and min(segments) > 0      # the engine passes decoded
    assert graphs.stats["arena_allocs"] == 1
    assert engine_keys <= set(graphs.captured())
    assert "decode graphs:" in lines[-1] and "'arena_allocs': 1" in lines[-1]


def test_failing_beam_capture_raises(cuda):
    """A beam step that reads a value back to the host cannot be captured:
    beam search raises (in a child process, as the greedy test) instead of
    falling back to the eager loop."""
    import os
    import subprocess
    import sys

    code = """
import torch
from clearconverse_tpu_torch.models import decoding
import test_torch_cuda as t
orig = decoding._beam_step
def syncing(s, c):
    orig(s, c)
    float(s.slp[0])
decoding._beam_step = syncing
model, dims = t._graph_model()
try:
    t._beam_call(model, dims, 2, 5,
                 suppress_tokens=(50256,) + tuple(range(50257, 51864)))
except RuntimeError as exc:
    print("RAISED", "capture failed" in str(exc))
else:
    print("NO ERROR")
"""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, here]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=root)
    assert "RAISED True" in proc.stdout, (proc.stdout, proc.stderr[-3000:])
