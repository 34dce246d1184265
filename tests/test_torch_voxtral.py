"""Voxtral Mini 3B on the CPU (models/voxtral.py, decoding.
voxtral_decode_from_audio) against the plain float32 reference
(benchmark/ccbench/voxtral_reference.py, loaded by path; it imports nothing
of the port or of JAX), at a small size with seeded random weights: an
encoder of 2 layers at d 64, a decoder of 2 layers with 4 query and 2 K/V
heads of 16 at d 48 (so the 64-wide attention output is projected back to
48, as Voxtral's 4096 to 3072), a vocabulary of 1,300 and the 4-frame
stack kept.

Held here: the prefill's logits and each loop step's logits through the
prefix and suffix caches against the reference's full forward along the
same tokens; replicas sharing one prefix against the same rows with the
prefix replicated; the bf16 route within a bound that an fp8 reference
fails; ``process_files`` end to end with a segment over 30 s (the fixed
30 s cuts); the HF loader; the server's factory with ``WHISPER_MODEL_SIZE``
and ``CC_TORCH_SEPARATOR``.

One torch thread, TF32 off.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from clearconverse_tpu_torch.audio.mel import log_mel_auto, pad_or_trim
from clearconverse_tpu_torch.models import voxtral as vx
from clearconverse_tpu_torch.models.convert import (
    load_voxtral, load_voxtral_state_dict, voxtral_hf_names)
from clearconverse_tpu_torch.models.tokenizer import (
    TekkenByteTokenizer, TekkenSpecials)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = vx.VoxtralDims(n_audio_state=64, n_audio_head=4, n_audio_layer=2,
                      d_model=48, n_layer=2, n_head=4, n_kv_head=2,
                      head_dim=16, d_ffn=96, n_vocab=1300)
TOK = TekkenByteTokenizer(TekkenSpecials(n_vocab=TINY.n_vocab))
HEAD, TAIL = TOK.specials.prompt(TOK.language_ids("en"))
P = len(HEAD) + TINY.audio_rows + len(TAIL)
TARGET = 30 * 16000
# Prefill and cached steps against the full forward, both in IEEE f32,
# as a share of the largest logit: the same operations in another
# association (batched products, the prefix and suffix scores
# concatenated, RoPE from a 0-d position) read 4.5e-7 to 5.8e-7 over
# three seeds; a step fed the wrong tokens reads 0.36 or more.
F32_TOL = 5e-6
# The bf16 route against the f32 reference: the largest gap of a
# log-probability over the prefill and 5 steps, in nats. bf16 reads
# 0.023-0.033 over three seeds, fp8 operands 0.49-0.70: the bound sits 3x
# above the one and 4.9x below the other.
BF16_BOUND = 0.1


def _reference():
    bench = os.path.join(ROOT, "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    path = os.path.join(bench, "ccbench", "voxtral_reference.py")
    spec = importlib.util.spec_from_file_location("voxtral_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(n)
    torch.backends.cuda.matmul.allow_tf32 = mm


def ref_dims(d: vx.VoxtralDims) -> dict:
    """The dims under HF's names, as the reference reads them."""
    return {"audio_config": {
                "num_mel_bins": d.n_mels, "hidden_size": d.n_audio_state,
                "intermediate_size": d.stack * d.n_audio_state,
                "num_hidden_layers": d.n_audio_layer,
                "num_attention_heads": d.n_audio_head,
                "max_source_positions": d.n_audio_ctx},
            "text_config": {
                "hidden_size": d.d_model, "intermediate_size": d.d_ffn,
                "num_hidden_layers": d.n_layer, "num_attention_heads": d.n_head,
                "num_key_value_heads": d.n_kv_head, "head_dim": d.head_dim,
                "vocab_size": d.n_vocab, "rms_norm_eps": d.rms_eps,
                "rope_theta": d.rope_theta}}


def seeded(dims=TINY, seed=0, dtype=torch.float32) -> vx.Voxtral:
    """A Voxtral with every norm and bias drawn too (gains 1 + N(0,
    0.1^2), offsets and biases N(0, 0.02^2)), so no weight is left at a
    value that would hide a missing product."""
    model = vx.init_voxtral(dims, seed, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(seed + 1)

    def draw(p, scale, offset=0.0):
        p.copy_(offset + scale * torch.randn(p.shape, generator=gen))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.LayerNorm, vx._RMSNorm)):
                draw(m.weight, 0.1, 1.0)
            if getattr(m, "bias", None) is not None:
                draw(m.bias, 0.02)
    if dtype == torch.float32:
        return model
    out = vx.empty_voxtral(dims, "cpu", dtype)
    load_voxtral_state_dict(out, hf_weights(model))
    return out


def hf_weights(model: vx.Voxtral) -> dict:
    """The model's tensors under HF's names, in float32."""
    params = dict(model.named_parameters())
    return {hf: params[pt].detach().float().clone()
            for hf, pt in voxtral_hf_names(model.dims).items()}


def _audio(n: int, seed: int = 0, seconds: float = 30.0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (0.1 * rng.standard_normal((n, int(seconds * 16000))))
        .astype(np.float32))


def _program_logits(model, audio, tokens, R: int = 1, cdt=torch.float32):
    """Prefill logits, then each loop step's, through the caches: [U·R,
    1 + k, V] f32 along ``tokens`` [U·R, k]."""
    mel = log_mel_auto(pad_or_trim(audio.float(), TARGET), TINY.n_mels)
    rows = vx.encode_audio(model, mel, cdt)
    x = vx.prompt_embeddings(model, rows, HEAD, TAIL)
    prefix, last = vx.prefix_prefill(model, x, cdt)
    U = audio.shape[0]
    k = tokens.shape[1]
    M = k + 3
    suffix = vx.suffix_cache(model.dims, U, R, M, cdt, "cpu")
    out = [last.repeat_interleave(R, dim=0)]
    with torch.inference_mode():
        for j in range(1, k + 1):
            out.append(vx.step_forward(
                model, tokens[:, j - 1], torch.tensor(j), prefix, suffix,
                torch.arange(M), P, cdt))
    return torch.stack(out, dim=1)


def _reference_logits(w, audio, tokens, fp8=False):
    ops = REF.Ops(fp8)
    with REF.ieee_f32(), torch.no_grad():
        feats = REF.audio_rows(ops, w, ref_dims(TINY), audio, TARGET)
        return REF.full_logits(ops, w, ref_dims(TINY), feats, HEAD, TAIL,
                               tokens, tokens.shape[1] + 1)


def _tokens(rows: int, k: int, seed: int = 1) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1000, TINY.n_vocab, (rows, k), generator=g)


def test_published_widths_hold_4_68_b_parameters():
    with torch.device("meta"):
        model = vx.Voxtral(vx.VoxtralDims())
    assert sum(p.numel() for p in model.parameters()) == 4_676_271_104
    assert P == 387


def test_prefill_and_cached_steps_match_the_full_forward():
    model = seeded()
    audio = _audio(2)
    tokens = _tokens(2, 5)
    got = _program_logits(model, audio, tokens)
    want = _reference_logits(hf_weights(model), audio, tokens)
    assert got.shape == want.shape == (2, 6, TINY.n_vocab)
    scale = want.abs().max()
    err = (got - want).abs().max() / scale
    assert err < F32_TOL, err
    # A step that read the wrong suffix slot is far off.
    wrong = _program_logits(model, audio, tokens.roll(1, dims=1))
    assert ((wrong - want)[:, 2:].abs().max() / scale) > 1e-2


def test_replicas_sharing_a_prefix_match_the_rows_replicated():
    model = seeded(seed=3)
    audio = _audio(2, seed=4)
    R = 3
    tokens = _tokens(2 * R, 4, seed=5)
    shared = _program_logits(model, audio, tokens, R=R)
    alone = _program_logits(model, audio.repeat_interleave(R, dim=0), tokens)
    torch.testing.assert_close(shared, alone, rtol=0, atol=1e-5)
    # The replicas drew different tokens, so their steps differ.
    assert (shared[0, 1:] - shared[1, 1:]).abs().max() > 1e-2


def _logprob_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((torch.log_softmax(a.float(), -1)
                  - torch.log_softmax(b.float(), -1)).abs().max())


def test_the_bf16_route_holds_a_bound_that_fp8_fails():
    model = seeded(seed=6, dtype=torch.bfloat16)
    w = hf_weights(model)            # the served bf16 values, in f32
    audio = _audio(2, seed=7)
    tokens = _tokens(2, 5, seed=8)
    want = _reference_logits(w, audio, tokens)
    bf16 = _logprob_gap(_program_logits(model, audio, tokens,
                                        cdt=torch.bfloat16), want)
    fp8 = _logprob_gap(_reference_logits(w, audio, tokens, fp8=True), want)
    assert bf16 < BF16_BOUND < fp8, (bf16, fp8)


def test_the_decode_samples_replicas_over_one_prefix():
    from clearconverse_tpu_torch.models import decoding as dec
    from clearconverse_tpu_torch.utils.tracing import StageTimer
    model = seeded(seed=9)
    opts = dec.DecodeOptions(
        max_tokens=6, temperature=0.5, eot=TOK.specials.eos,
        suppress_blank=False, suppress_tokens=TOK.specials.control_ids(),
        compute_dtype=torch.float32, replicas=3)
    timer = StageTimer()
    out = dec.voxtral_decode_from_audio(
        model, _audio(2, seed=10, seconds=7.0), HEAD, TAIL, opts,
        torch.Generator().manual_seed(1), timer=timer)
    toks = out["tokens"]
    assert toks.shape == (6, 6)
    assert bool(((toks >= 1000) | (toks == TOK.specials.eos)).all())
    c = out["counts"]
    assert c == dec.voxtral_counts(2, P, 3, 5)
    assert c["prefix_copies"] == 1 and c["rows"] == 3 * c["prefix_rows"]
    assert set(timer.as_dict()) == {"log_mel", "encoder", "adapter",
                                    "prefix_prefill", "token_loop"}
    assert timer.counts["token_loop_steps"] == 5
    # The served sums are the reference's along the served tokens.
    w = hf_weights(model)
    ref = REF.served_logprob_sums(
        w, ref_dims(TINY), _audio(2, seed=10, seconds=7.0), HEAD, TAIL, toks,
        out["lengths"], list(range(6)), 3, TOK.specials.control_ids(), 6,
        TARGET)
    np.testing.assert_allclose(out["sum_logprob"].double().numpy(), ref,
                               atol=1e-3)


def _tiny_engine(tmp_path, **tc):
    from clearconverse_tpu_torch.config import Config, TorchConfig
    from clearconverse_tpu_torch.pipeline.engine import TranscriptionEngine
    cfg = dict(max_decode_tokens=6, best_of=3, diarization_onset=0.35,
               diarization_offset=0.25)
    cfg.update(tc)
    eng = TranscriptionEngine(
        Config(whisper_model_size=vx.NAME, temperature=0.1,
               transcription_batch_size=4),
        TorchConfig(**cfg), model_dir=str(tmp_path), device="cpu")
    eng.models._voxtral_dims = TINY
    return eng


def test_process_files_runs_voxtral_with_fixed_30_s_cuts(tmp_path):
    from clearconverse_tpu_torch.audio.wav import write_wav
    from clearconverse_tpu_torch.pipeline.dev_backend import (
        SR, synth_conversation)
    eng = _tiny_engine(tmp_path)
    x = np.tile(synth_conversation(), 4)[: 40 * SR]
    path = str(tmp_path / "a.wav")
    write_wav(path, x, SR)
    res = eng.process_files([path])
    b = eng.models
    assert b.load_source["voxtral"] == "random_init"
    assert b._whisper is None and b._voxtral is not None and not b.seeks
    segs = res[0]["segments"]
    assert segs and all(isinstance(s.transcription, str) for s in segs)
    assert any(s.end - s.start > 30 for s in segs)
    d = b.last_decode
    assert d["prefix_copies"] == 1 and d["rows"] == 3 * d["prefix_rows"]
    # Every segment's windows: the long one in two cuts (30 + 10 s).
    assert d["prefix_rows"] == sum(-(-(s.end - s.start) // 30) for s in segs)
    assert d["prefix_positions"] == P * d["prefix_rows"]
    with pytest.raises(ValueError, match="does not seek"):
        b.transcribe_long_batch(np.zeros((1, 16000), np.float32), [""])


def test_the_hf_loader_reads_a_model_directory(tmp_path):
    from clearconverse_tpu_torch.config import Config
    from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
    from clearconverse_tpu_torch.utils.safetensors import save_file
    model = seeded(seed=11)
    w = hf_weights(model)
    folder = tmp_path / vx.NAME
    folder.mkdir()
    names = sorted(w)
    half = len(names) // 2
    # Two shards; the second without ``model.`` in the language model's
    # names, as some exports write them.
    save_file({k: w[k] for k in names[:half]},
              str(folder / "model-00001-of-00002.safetensors"))
    save_file({k.replace("language_model.model.", "language_model."): w[k]
               for k in names[half:]},
              str(folder / "model-00002-of-00002.safetensors"))
    got = load_voxtral(str(tmp_path), vx.NAME, TINY, "cpu", torch.float32)
    for (n, a), (_, b) in zip(got.named_parameters(),
                              model.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    with pytest.raises(KeyError, match="missing"):
        load_voxtral_state_dict(vx.empty_voxtral(TINY, "cpu"),
                                {k: w[k] for k in names[1:]})
    b = ModelBundle(Config(whisper_model_size=vx.NAME),
                    model_dir=str(tmp_path), device="cpu")
    b._voxtral_dims = TINY
    b.load_with_progress()
    assert b.load_source["voxtral"] == "checkpoint"
    assert b.load_source["tokenizer"] == "TekkenByteTokenizer"


def test_the_tekken_byte_layout():
    sp = TekkenSpecials()
    assert TOK.encode("é") == [1000 + 0xC3, 1000 + 0xA9]
    assert TOK.decode([1, 1000 + ord("h"), 5, 1000 + ord("i"), 2]) == "hi"
    assert len(sp.control_ids()) == 999 and sp.eos not in sp.control_ids()
    head, tail = sp.prompt(TOK.language_ids("en"))
    assert head == (1, 3, 25) and tail[0] == 4 and tail[-1] == 34
    assert len(head) + 375 + len(tail) == 387
    assert sp.prompt(TOK.language_ids(None))[1] == (4, 34)


def _factory_engine(monkeypatch, tmp_path, env):
    """The server's default factory with ``env`` set, its engine on the
    CPU (the factory builds for the card)."""
    from clearconverse_tpu_torch.pipeline import engine as engine_mod
    from clearconverse_tpu_torch.serve.factory import default_engine_factory
    for k in ("WHISPER_MODEL_SIZE", "CC_TORCH_SEPARATOR",
              "CC_TPU_FAKE_MODELS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("ENV_FILE", str(tmp_path / "absent.env"))
    monkeypatch.setenv("MODEL_CACHE_DIR", str(tmp_path / "models"))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    real = engine_mod.TranscriptionEngine

    def on_cpu(*args, **kwargs):
        return real(*args, **{**kwargs, "device": "cpu"})

    monkeypatch.setattr(engine_mod, "TranscriptionEngine", on_cpu)
    return default_engine_factory()


@pytest.mark.parametrize("size", [None, vx.NAME])
def test_the_served_factory_reads_whisper_model_size(monkeypatch, tmp_path,
                                                     size):
    eng = _factory_engine(monkeypatch, tmp_path,
                          {"WHISPER_MODEL_SIZE": size} if size else {})
    assert eng.config.whisper_model_size == (size or "small.en")
    assert eng.models.config.whisper_model_size == (size or "small.en")
    assert eng.models.seeks == (size is None)
    if size:
        eng.models._voxtral_dims = TINY
        assert eng.models.load_with_progress()
        assert isinstance(eng.models._voxtral[0], vx.Voxtral)


def test_the_served_factory_reads_cc_torch_separator(monkeypatch, tmp_path):
    from clearconverse_tpu_torch.models import resepformer as rsf
    eng = _factory_engine(monkeypatch, tmp_path,
                          {"CC_TORCH_SEPARATOR": "resepformer-wsj02mix"})
    assert eng.torch_config.separator == "resepformer-wsj02mix"
    assert isinstance(eng.models._load_sepformer(), rsf.Resepformer)
    assert eng.models.load_source["sepformer"] == "random_init"
    unset = _factory_engine(monkeypatch, tmp_path, {})
    assert unset.torch_config.separator == "sketch"
