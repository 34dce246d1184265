"""Port ModelBundle against the JAX ModelBundle with the same tiny weights
injected into both (the pattern of tests/test_bundle.py): identical texts
from transcribe_batch at t=0 for host and store batches, and identical
_decode_with_fallback outputs under one shared scripted decode."""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from clearconverse_tpu.config import Config as JConfig, TPUConfig
from clearconverse_tpu.models.tokenizer import ByteFallbackTokenizer as JTok
from clearconverse_tpu.models.whisper import WhisperDims as JDims
from clearconverse_tpu.models.whisper import init_whisper_params
from clearconverse_tpu.pipeline.bundle import ModelBundle as JBundle
from clearconverse_tpu.pipeline.bundle import StoreBatch as JStoreBatch

from clearconverse_tpu_torch.config import TorchConfig
from clearconverse_tpu_torch.models.convert import whisper_from_jax_params
from clearconverse_tpu_torch.models.tokenizer import ByteFallbackTokenizer
from clearconverse_tpu_torch.models.whisper import WhisperDims
from clearconverse_tpu_torch.pipeline.bundle import ModelBundle, StoreBatch

KW = dict(n_mels=80, n_vocab=51864, n_audio_ctx=1500, n_audio_state=64,
          n_audio_head=2, n_audio_layer=1, n_text_ctx=448, n_text_state=64,
          n_text_head=2, n_text_layer=1)
KNOBS = dict(max_decode_tokens=8, max_fallback_attempts=2,
             compute_dtype="float32", cross_kv_bits=16)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def bundles():
    """Both bundles on the same weights. The token table's rows above the
    256 byte ids shrink 100x (EOT's row kept), so the byte-fallback
    tokenizer renders non-empty text from random weights."""
    params = jax.tree.map(np.array, init_whisper_params(jax.random.PRNGKey(0),
                                                        JDims(**KW)))
    tok = params["decoder"]["tok"]
    tok[256:50256] *= 0.01
    jb = JBundle(JConfig(), TPUConfig(**KNOBS))
    jb._whisper = (params, JDims(**KW), JTok(english=True))
    jb._loaded = True
    tb = ModelBundle(torch_config=TorchConfig(**KNOBS), device="cpu")
    tb._whisper = (whisper_from_jax_params(params, WhisperDims(**KW), "cpu"),
                   WhisperDims(**KW), ByteFallbackTokenizer(english=True))
    tb._loaded = True
    return jb, tb


def _audio(n, t=16000, seed=0):
    return (np.random.default_rng(seed).standard_normal((n, t))
            .astype(np.float32) * 0.1)


def test_transcribe_batch_host_identical_texts(bundles):
    jb, tb = bundles
    audio = _audio(3)
    prompts = ["", "context prompt", "x"]
    ref = jb.transcribe_batch(audio, prompts, temperature=0.0)
    ours = tb.transcribe_batch(audio, prompts, temperature=0.0)
    assert ours == ref
    assert any(ours)          # random bytes, but not all empty


def test_transcribe_batch_store_identical_texts(bundles):
    jb, tb = bundles
    full = _audio(2, 40000, seed=1)
    rows, starts, lens = [0, 1, 1], [0, 3000, 20000], [16000, 12000, 16000]
    js = jb.make_store(full, 16000)
    ts = tb.make_store(full, 16000)
    ref = jb.transcribe_batch(JStoreBatch(js, rows, starts, lens, 16000),
                              ["", "a", "b"], temperature=0.0)
    ours = tb.transcribe_batch(StoreBatch(ts, rows, starts, lens, 16000),
                               ["", "a", "b"], temperature=0.0)
    assert ours == ref
    windows = np.stack([np.pad(full[r, s:s + n], (0, 16000 - n))
                        for r, s, n in zip(rows, starts, lens)])
    np.testing.assert_array_equal(
        StoreBatch(ts, rows, starts, lens, 16000).gather().numpy(), windows)
    assert tb.transcribe_batch(windows, ["", "a", "b"],
                               temperature=0.0) == ours


class _Script:
    """A scripted decode_rows shared by both bundles: canned (tokens,
    lengths, sum_logprob, no_speech_prob) per call, keyed by row."""

    def __init__(self, script, mt=8, eot=50256):
        self.script, self.mt, self.eot = script, mt, eot
        self.calls = []

    def __call__(self, audio_rows, toks_rows, lens_rows, temp, replicas=1):
        rows = len(toks_rows)
        assert rows == audio_rows.shape[0] * replicas
        self.calls.append((rows, temp, replicas))
        spec = self.script[min(len(self.calls) - 1, len(self.script) - 1)]
        tokens = np.full((rows, self.mt), self.eot, np.int32)
        lengths = np.zeros(rows, np.int32)
        slp = np.zeros(rows, np.float32)
        nsp = np.zeros(rows, np.float32)
        for i in range(rows):
            row = spec.get(i, spec.get("default", {}))
            n = row.get("n", 3)
            tokens[i, :n] = row.get("token", 65 + i % 26)
            lengths[i] = n
            slp[i] = row.get("slp", -0.5)
            nsp[i] = row.get("nsp", 0.0)
        return tokens, lengths, slp, nsp


SCRIPTS = {
    # best_of ranking: scalar t > 0, replicas 3; the best sum_lp/len wins.
    "best_of": (0.4, [{"default": {"slp": -2.0}, 1: {"slp": -0.1, "n": 5},
                       4: {"slp": -0.3, "token": 90}}]),
    # fallback ladder: rows 2 fails the gate at rung 0, passes at rung 1.
    "ladder": ((0.0, 0.2, 0.4), [{"default": {"slp": -0.5},
                                  2: {"slp": -90.0}},
                                 {"default": {"slp": -0.2, "token": 70}}]),
    # no-speech gate: a confident-silence row never retries.
    "no_speech": ((0.0, 0.2), [{0: {"nsp": 0.95, "slp": -40.0},
                                "default": {"slp": -0.5}}]),
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_decode_with_fallback_identical(bundles, case):
    jb, tb = bundles
    temperature, script = SCRIPTS[case]
    saved = jb.tpu, tb.torch_config
    jb.tpu = dataclasses.replace(jb.tpu, best_of=3, max_fallback_attempts=3)
    tb.torch_config = dataclasses.replace(tb.torch_config, best_of=3,
                                          max_fallback_attempts=3)
    toks = np.zeros((4, 4), np.int32)
    lens = np.full(4, 2, np.int32)
    audio = np.zeros((4, 100), np.float32)
    tok = ByteFallbackTokenizer()
    outs = []
    try:
        for b in (jb, tb):
            fake = _Script(script)
            outs.append((b._decode_with_fallback(
                fake, audio, toks, lens, temperature, 3,
                text_of=lambda tk, n: tok.decode(tk[:n]), eot=50256),
                fake.calls))
    finally:
        jb.tpu, tb.torch_config = saved
    (ref, ref_calls), (ours, our_calls) = outs
    assert our_calls == ref_calls
    for a, b in zip(ours, ref):
        if isinstance(a, list):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)


def test_tuple_temperature_ladder_runs(bundles):
    _, tb = bundles
    texts = tb.transcribe_batch(_audio(2, seed=2), ["", "p"],
                                temperature=(0.0, 0.2))
    assert len(texts) == 2 and all(isinstance(t, str) for t in texts)


def test_sampling_rung_uses_best_of_replicas(bundles):
    _, tb = bundles
    texts = tb.transcribe_batch(_audio(1, seed=3), [""], temperature=0.1)
    assert len(texts) == 1 and isinstance(texts[0], str)


@pytest.mark.parametrize("entry", ["make_train_step", "train_cli"])
def test_unported_methods_name_their_roadmap_item(entry, tmp_path):
    """Training on a device mesh (once ROADMAP item 9) is ported, and its
    entry points refuse what they cannot run instead of training at 1x1:
    the mesh step a batch that does not split over the data axis, the CLI
    a mesh without a process group of ranks (naming how to start one)."""
    if entry == "make_train_step":
        from clearconverse_tpu_torch.parallel.mesh import Mesh
        from clearconverse_tpu_torch.train.finetune import make_train_step
        mesh = Mesh(3, 1, 0, torch.device("cpu"), "gloo", {})
        step = make_train_step(WhisperDims(**KW), mesh=mesh)
        call = lambda: step(None, {"tokens": torch.zeros((4, 6))})  # noqa: E731
        raises, match = ValueError, "batch 4 not divisible by .* data=3"
    else:
        from clearconverse_tpu_torch.train.__main__ import main
        call = lambda: main(["--data_dir", str(tmp_path), "--mesh", "2x1",  # noqa: E731
                             "--device", "cpu"])
        raises, match = RuntimeError, "torchrun"
    with pytest.raises(raises, match=match):
        call()


def test_default_device_is_cuda():
    """Entry points run on the card unless the caller asks for the CPU:
    without a card, the default bundle refuses instead of falling back."""
    if torch.cuda.is_available():
        assert ModelBundle().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ModelBundle()


def test_configs_mirror_the_jax_package():
    """Config is a copy; TorchConfig keeps TPUConfig's defaults for every
    field, and CC_TORCH_* variables override like CC_TPU_* ones. The one
    field of the port's own, the separator, defaults to the JAX package's
    layout."""
    from clearconverse_tpu_torch.config import Config, torch_config_from_env
    assert dataclasses.asdict(Config()) == dataclasses.asdict(JConfig())
    ours, ref = TorchConfig(), TPUConfig()
    port_only = {"separator": "sketch"}
    for f in dataclasses.fields(TorchConfig):
        if f.name in port_only:
            assert not hasattr(ref, f.name), f.name
            assert getattr(ours, f.name) == port_only[f.name], f.name
            continue
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    env = {"CC_TORCH_CROSS_KV_BITS": "16", "CC_TORCH_PAD_FULL_WINDOW": "0",
           "CC_TORCH_LANGUAGE": "auto", "CC_TORCH_COMPUTE_DTYPE": "float32",
           "CC_TORCH_BEST_OF": ""}
    got = torch_config_from_env(env)
    assert (got.cross_kv_bits, got.pad_to_full_window, got.language,
            got.compute_dtype, got.best_of) == (16, False, None, "float32", 5)
