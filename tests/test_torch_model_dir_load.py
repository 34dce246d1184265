"""The loader cases of tests/test_model_dir_load.py, held on the port's
``models/convert.load_whisper_params`` and ``load_torch_state_dict``.

The checkpoints are written exactly as the JAX file writes them (openai
``.pt`` files from the JAX package's tiny weights, a safetensors overlay, a
lightning-layout pyannote bin with unimportable metadata); the port must
find the same files, take the same dims and return the same arrays. The
cold start of every family is tests/test_torch_dress_rehearsal.py's.
"""

import dataclasses
import shutil
import sys

import numpy as np
import pytest
import torch

import jax

from clearconverse_tpu.models.pyannet import PyannetDims as JPyannetDims
from clearconverse_tpu.models.pyannet import init_pyannet_params
from clearconverse_tpu.models.whisper import init_whisper_params

import test_model_dir_load as ref

from clearconverse_tpu_torch.models.convert import (
    infer_whisper_dims, load_torch_state_dict, load_whisper_params)
from clearconverse_tpu_torch.models.pyannet import convert_pyannote_pyannet
from clearconverse_tpu_torch.models.whisper import WhisperDims, model_dims

TINY = WhisperDims(**dataclasses.asdict(ref.TINY))


def _tok(params):
    return np.asarray(params["decoder"]["tok"])


def test_load_whisper_uses_checkpoint_dims(tmp_path):
    """The .pt's dims dict wins over the small.en table entry."""
    params = init_whisper_params(jax.random.PRNGKey(7), ref.TINY)
    ref._save_openai_pt(tmp_path / "small.en.pt", params, ref.TINY)
    loaded, dims = load_whisper_params(str(tmp_path), "small.en")
    assert loaded is not None
    assert dims == TINY != model_dims("small.en")
    np.testing.assert_allclose(_tok(loaded), _tok(params), atol=0)


def test_load_whisper_accepts_reference_cache_layout(tmp_path):
    """{model_dir}/whisper/small.en.pt (whisper.load_model's download
    root) loads without moving files."""
    params = init_whisper_params(jax.random.PRNGKey(4), ref.TINY)
    (tmp_path / "whisper").mkdir()
    ref._save_openai_pt(tmp_path / "whisper" / "small.en.pt", params,
                        ref.TINY)
    loaded, dims = load_whisper_params(str(tmp_path), "small.en")
    assert loaded is not None and dims == TINY
    np.testing.assert_allclose(_tok(loaded), _tok(params), atol=0)


def test_load_whisper_infers_dims_from_bare_state_dict(tmp_path):
    """No dims entry: shape fields from the weights, head counts from the
    name table."""
    params = init_whisper_params(jax.random.PRNGKey(3), ref.TINY)
    sd = {k: torch.tensor(np.asarray(v)) for k, v in
          ref.whisper_to_openai_state_dict(params).items()}
    torch.save(sd, str(tmp_path / "small.en.pt"))
    loaded, dims = load_whisper_params(str(tmp_path), "small.en")
    assert loaded is not None
    assert dims.n_audio_state == 64 and dims.n_text_state == 64
    assert dims.n_audio_layer == 1 and dims.n_text_layer == 1
    assert dims.n_vocab == TINY.n_vocab
    assert dims.n_audio_head == model_dims("small.en").n_audio_head


def test_ft_overlay_shapes_win(tmp_path):
    """A vocab-extended whisper-ft/model.safetensors overrides the base:
    the dims come from the final weights, the heads from the base .pt."""
    from safetensors.numpy import save_file
    base = init_whisper_params(jax.random.PRNGKey(7), ref.TINY)
    ref._save_openai_pt(tmp_path / "small.en.pt", base, ref.TINY)
    grown = dataclasses.replace(ref.TINY, n_vocab=ref.TINY.n_vocab + 7)
    ft_params = init_whisper_params(jax.random.PRNGKey(9), grown)
    (tmp_path / "whisper-ft").mkdir()
    save_file({k: np.ascontiguousarray(v) for k, v in
               ref.whisper_to_openai_state_dict(ft_params).items()},
              str(tmp_path / "whisper-ft" / "model.safetensors"))
    loaded, dims = load_whisper_params(str(tmp_path), "small.en")
    assert dims.n_vocab == TINY.n_vocab + 7
    assert dims.n_audio_head == TINY.n_audio_head
    np.testing.assert_allclose(_tok(loaded), _tok(ft_params), atol=0)


def test_infer_whisper_dims_roundtrip():
    params = jax.tree.map(np.asarray, init_whisper_params(
        jax.random.PRNGKey(1), ref.TINY))
    got = infer_whisper_dims(params, model_dims("small.en"))
    assert got == dataclasses.replace(TINY, n_audio_head=12, n_text_head=12)
    assert infer_whisper_dims(params, TINY) == TINY


def test_pyannote_lightning_metadata_does_not_block_tensors(tmp_path):
    """A lightning checkpoint whose metadata classes cannot be imported
    still yields its state dict, which converts to the written weights."""
    mod_dir = tmp_path / "mods"
    mod_dir.mkdir()
    (mod_dir / "cc_fake_pyannote_meta.py").write_text(
        "import enum\n"
        "class Problem(enum.Enum):\n    MULTI_LABEL = 2\n"
        "class Specifications:\n"
        "    def __init__(self, problem, duration):\n"
        "        self.problem, self.duration = problem, duration\n")
    sys.path.insert(0, str(mod_dir))
    try:
        import cc_fake_pyannote_meta as meta
        params = init_pyannet_params(jax.random.PRNGKey(5),
                                     JPyannetDims(**ref.TINY_PN))
        ckpt = {
            "pytorch-lightning_version": "2.0.0",
            "hyper_parameters": {"sincnet": {"stride": 10}},
            "pyannote.audio": {
                "architecture": {"module": "pyannote.audio.models.segmentation",
                                 "class": "PyanNet"},
                "specifications": meta.Specifications(
                    meta.Problem.MULTI_LABEL, 10.0),
            },
            "state_dict": ref._pyannet_state_dict(params),
        }
        path = tmp_path / "pytorch_model.bin"
        torch.save(ckpt, str(path))
    finally:
        sys.path.remove(str(mod_dir))
        sys.modules.pop("cc_fake_pyannote_meta", None)
    shutil.rmtree(mod_dir)
    with pytest.raises((ModuleNotFoundError, AttributeError, ImportError)):
        torch.load(str(path), map_location="cpu", weights_only=False)
    converted = convert_pyannote_pyannet(load_torch_state_dict(str(path)))
    want, got = jax.tree.leaves(params), jax.tree.leaves(converted)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(w), np.asarray(g), atol=1e-7)
