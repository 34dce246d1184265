"""The port's dress rehearsal (clearconverse_tpu_torch/eval/dress_rehearsal)
and inverse checkpoint writers, mirroring tests/test_dress_rehearsal.py at
tiny dims on the CPU: ``populate`` writes every family in its real on-disk
format; a port-written set cold-loads every family as ``checkpoint`` in the
port's and in the JAX package's ``ModelBundle``, and a JAX-written set in
the port's; the writers of carried-across JAX params equal the JAX package's
key for key and value for value; the bench's ``_ensure_models`` regenerates
a wiped directory and honours ``CC_BENCH_AUTOGEN_MODELS=0``."""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import torch

from clearconverse_tpu.config import Config as JConfig, TPUConfig
from clearconverse_tpu.eval import dress_rehearsal as jdr
from clearconverse_tpu.models import ecapa as jecapa
from clearconverse_tpu.models import pyannet as jpyannet
from clearconverse_tpu.models import tokenizer as jtok
from clearconverse_tpu.models import whisper as jw
from clearconverse_tpu.pipeline.bundle import ModelBundle as JBundle
from clearconverse_tpu.train import checkpoint as jckpt

from clearconverse_tpu_torch import bench
from clearconverse_tpu_torch.config import Config, TorchConfig
from clearconverse_tpu_torch.eval import dress_rehearsal as dr
from clearconverse_tpu_torch.models import ecapa as tecapa
from clearconverse_tpu_torch.models import pyannet as tpyannet
from clearconverse_tpu_torch.models import tokenizer as ttok
from clearconverse_tpu_torch.models.convert import (
    init_whisper, whisper_from_jax_params)
from clearconverse_tpu_torch.models.whisper import WhisperDims
from clearconverse_tpu_torch.pipeline.bundle import ModelBundle
from clearconverse_tpu_torch.train.checkpoint import whisper_to_openai_state_dict

torch.set_num_threads(1)

LAYOUT = ("small.en.pt", "vocab.json", "merges.txt",
          "embedding/embedding_model.ckpt", "segmentation/pytorch_model.bin",
          "resepformer-ft/encoder.ckpt", "resepformer-ft/masknet.ckpt",
          "resepformer-ft/decoder.ckpt")
ALL_CHECKPOINT = {"whisper": "checkpoint", "tokenizer": "BPETokenizer",
                  "ecapa": "checkpoint", "pyannet": "checkpoint",
                  "sepformer": "checkpoint"}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def port_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_rehearsal")
    dr.populate(str(d), tiny=True, seed=42, device="cpu")
    return d


def _port_bundle(model_dir):
    b = ModelBundle(Config(), TorchConfig(max_decode_tokens=8,
                                          max_fallback_attempts=1,
                                          compute_dtype="float32"),
                    model_dir=str(model_dir), device="cpu")
    assert b.load_with_progress()
    return b


@pytest.mark.parametrize("rel", LAYOUT)
def test_layout_matches_reference_discovery(port_set, rel):
    assert (port_set / rel).exists(), rel


def test_whisper_pt_is_fp16_openai_format(port_set):
    obj = torch.load(str(port_set / "small.en.pt"), map_location="cpu",
                     weights_only=False)
    assert set(obj) == {"dims", "model_state_dict"}
    assert obj["dims"] == dataclasses.asdict(WhisperDims(**dr._TINY_WHISPER))
    sd = obj["model_state_dict"]
    assert sd["decoder.token_embedding.weight"].dtype == torch.float16
    assert all(t.dtype == torch.float16 for t in sd.values())
    # openai's key projections carry no bias; conv weights are [Cout, Cin, k].
    assert "encoder.blocks.0.attn.key.bias" not in sd
    assert "decoder.blocks.0.cross_attn.key.bias" not in sd
    assert tuple(sd["encoder.conv1.weight"].shape) == (64, 80, 3)


def test_lightning_pyannet_wrapper(port_set):
    obj = torch.load(str(port_set / "segmentation/pytorch_model.bin"),
                     map_location="cpu", weights_only=False)
    assert {"pytorch-lightning_version", "hyper_parameters",
            "state_dict"} <= set(obj)
    sd = obj["state_dict"]
    assert "lstm.weight_ih_l0_reverse" in sd
    assert tuple(sd["sincnet.conv1d.0.filterbank.low_hz_"].shape)[1] == 1


def test_port_set_cold_loads_in_port_bundle(port_set):
    """Every family as ``checkpoint``; the reloaded Whisper equals the
    fp16-rounded module that was written (max error 0)."""
    b = _port_bundle(port_set)
    assert b.load_source == ALL_CHECKPOINT
    model, dims, tok = b._whisper
    assert dims == WhisperDims(**dr._TINY_WHISPER)
    assert isinstance(tok, ttok.BPETokenizer)
    written = init_whisper(dims, 42, "cpu")
    got = dict(model.named_parameters())
    for name, p in written.named_parameters():
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], p.detach().half().float()), name
    assert b._ecapa["conv1"]["w"].dtype == torch.float32


def test_port_set_cold_loads_in_jax_bundle(port_set):
    b = JBundle(JConfig(), TPUConfig(max_decode_tokens=8,
                                     max_fallback_attempts=1,
                                     compute_dtype="float32"),
                model_dir=str(port_set))
    assert b.load_with_progress()
    assert b.load_source == ALL_CHECKPOINT
    params, dims, tok = b._whisper
    assert np.asarray(params["decoder"]["tok"]).dtype == np.float32
    assert dims.n_audio_state == 64 and dims.n_vocab == 51864
    assert isinstance(tok, jtok.BPETokenizer)


def test_jax_set_cold_loads_in_port_bundle(tmp_path):
    jdr.populate(str(tmp_path), tiny=True, seed=7)
    b = _port_bundle(tmp_path)
    assert b.load_source == ALL_CHECKPOINT
    assert b._whisper[1].n_audio_state == 64
    assert isinstance(b._whisper[2], ttok.BPETokenizer)


def test_port_written_tokenizer_ranks_equal_jax(port_set):
    ours = ttok.load_tokenizer(str(port_set))
    ref = jtok.load_tokenizer(str(port_set))
    assert ours.vocab == ref.vocab and ours.ranks == ref.ranks
    ids = ours.encode("hello world")
    assert ids == ref.encode("hello world")
    assert ours.decode(ids) == "hello world"


def test_tokenizer_assets_are_structurally_valid_bpe(tmp_path):
    dr.write_tokenizer(str(tmp_path), n_merges=500)
    vocab = json.loads((tmp_path / "vocab.json").read_text(encoding="utf-8"))
    assert len(vocab) == 256 + 500 + 1
    assert vocab["<|endoftext|>"] == 756
    seen = set(tok for tok, i in vocab.items() if i < 256)
    merged = 0
    for line in (tmp_path / "merges.txt").read_text(
            encoding="utf-8").splitlines():
        if line.startswith("#version"):
            continue
        a, b = line.split(" ")
        assert a in seen and b in seen
        seen.add(a + b)
        merged += 1
    assert merged == 500


def test_full_scale_tokenizer_equals_jax_writer(tmp_path):
    """50,000 merges: the GPT-2 height (50,257 entries), the same files as
    the JAX package writes."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    dr.write_tokenizer(str(tmp_path / "port"), n_merges=50000)
    jdr.write_tokenizer(str(tmp_path / "jax"), n_merges=50000)
    for name in ("vocab.json", "merges.txt"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    vocab = json.loads((tmp_path / "port" / "vocab.json").read_text(
        encoding="utf-8"))
    assert len(vocab) == 50257 and vocab["<|endoftext|>"] == 50256


def _assert_same_state_dict(ours, ref):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        a = np.asarray(ours[k])
        assert a.dtype == np.float32 and a.shape == np.shape(v), k
        np.testing.assert_array_equal(a, np.asarray(v, np.float32), err_msg=k)


def test_whisper_writer_equals_jax():
    dims = jw.WhisperDims(**jdr._TINY_WHISPER)
    params = jax.tree.map(np.asarray,
                          jw.init_whisper_params(jax.random.PRNGKey(3), dims))
    model = whisper_from_jax_params(params, WhisperDims(**jdr._TINY_WHISPER),
                                    "cpu")
    _assert_same_state_dict(whisper_to_openai_state_dict(model),
                            jckpt.whisper_to_openai_state_dict(params))


def test_ecapa_writer_equals_jax():
    params = jax.tree.map(np.asarray, jecapa.init_ecapa_params(
        jax.random.PRNGKey(4), jecapa.EcapaDims(**jdr._TINY_ECAPA)))
    _assert_same_state_dict(
        tecapa.ecapa_to_state_dict(tecapa.ecapa_from_jax_params(params, "cpu")),
        jecapa.ecapa_to_state_dict(params))


@pytest.mark.parametrize("layers", [1, 2])
def test_pyannet_writer_equals_jax(layers):
    kw = dict(jdr._TINY_PN, lstm_layers=layers)
    params = jax.tree.map(np.asarray, jpyannet.init_pyannet_params(
        jax.random.PRNGKey(5), jpyannet.PyannetDims(**kw)))
    ours = tpyannet.pyannet_from_jax_params(params, tpyannet.PyannetDims(**kw),
                                            "cpu")
    _assert_same_state_dict(tpyannet.pyannet_to_state_dict(ours),
                            jpyannet.pyannet_to_state_dict(params))


def test_port_writers_round_trip_through_port_loaders():
    """ECAPA and PyanNet: write → convert → the same weights."""
    p = tecapa.init_ecapa(tecapa.EcapaDims(**dr._TINY_ECAPA), 1, "cpu")
    back = tecapa.ecapa_from_jax_params(tecapa.convert_speechbrain_ecapa(
        dr._tensorize(tecapa.ecapa_to_state_dict(p))), "cpu")
    assert torch.equal(back["blocks"][0]["conv_in"]["w"],
                       p["blocks"][0]["conv_in"]["w"])
    assert torch.equal(back["asp_bn"]["var"], p["asp_bn"]["var"])
    dims = tpyannet.PyannetDims(**dr._TINY_PN)
    q = tpyannet.init_pyannet(dims, 2, "cpu")
    sd = tpyannet.pyannet_to_state_dict(q)
    back = tpyannet.pyannet_from_jax_params(
        tpyannet.convert_pyannote_pyannet(dr._tensorize(sd)), dims, "cpu")
    assert tpyannet.pyannet_to_state_dict(back).keys() == sd.keys()
    for k, v in tpyannet.pyannet_to_state_dict(back).items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)


def test_populate_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dr.populate(str(tmp_path), tiny=True)
    assert not os.listdir(tmp_path)


def test_bench_ensure_models_regenerates_and_opts_out(tmp_path, monkeypatch):
    """present → no-op; wiped → written (at tiny dims here) and cold-loads
    as checkpoint; a budget too deep → skipped; CC_BENCH_AUTOGEN_MODELS=0 →
    off; a failing writer → "error: ..." in the line, not swallowed."""
    calls = []
    real = dr.populate

    def tiny_populate(model_dir, size, device):
        calls.append((model_dir, size, str(device)))
        return real(model_dir, size, tiny=True, device=device)

    monkeypatch.setattr(dr, "populate", tiny_populate)
    d = tmp_path / "models"
    os.makedirs(d / "whisper")
    (d / "whisper" / "small.en.pt").write_bytes(b"")
    assert bench._ensure_models(str(d), "cpu") == "present"
    assert calls == []

    os.remove(d / "whisper" / "small.en.pt")
    assert bench._ensure_models(str(d), "cpu").startswith("generated in")
    assert calls == [(str(d), "small.en", "cpu")]
    assert _port_bundle(d).load_source == ALL_CHECKPOINT

    os.remove(d / "small.en.pt")
    monkeypatch.setattr(bench, "_T0", bench._T0 - 1e6)
    assert bench._ensure_models(str(d), "cpu", budget_s=1e6).startswith(
        "skipped")
    monkeypatch.setenv("CC_BENCH_AUTOGEN_MODELS", "0")
    assert bench._ensure_models(str(d), "cpu") == "off"
    assert len(calls) == 1

    monkeypatch.delenv("CC_BENCH_AUTOGEN_MODELS")

    def broken(model_dir, size, device):
        raise OSError("disk full")

    monkeypatch.setattr(dr, "populate", broken)
    assert bench._ensure_models(str(d), "cpu") == "error: OSError: disk full"
