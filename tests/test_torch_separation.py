"""The port's RE-SepFormer (models/resepformer.py) and the bundle's
separate_batch against the JAX package on the same seeded numpy weights and
inputs, f32, with tests/test_speaker_golden.py's tolerance (rtol 1e-3,
atol 1e-4)."""

import dataclasses
import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from clearconverse_tpu.models import resepformer as J

from clearconverse_tpu_torch.config import TorchConfig
from clearconverse_tpu_torch.models import resepformer as P
from clearconverse_tpu_torch.pipeline.bundle import ModelBundle

# Six pytest workers share the host; one intra-op thread each keeps these
# small ops fast.
torch.set_num_threads(1)

RTOL, ATOL = 1e-3, 1e-4
JDIMS = J.SepformerDims(enc_channels=12, enc_kernel=8, d_model=16, n_heads=2,
                        ff_mult=2, chunk_size=10, n_repeats=2,
                        n_intra_layers=2, n_inter_layers=1)
PDIMS = P.SepformerDims(**dataclasses.asdict(JDIMS))


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    """The JAX package's seeded init (numpy leaves) and the port module
    holding the same weights."""
    tree = _np_tree(J.init_sepformer_params(jax.random.PRNGKey(5), JDIMS))
    return tree, P.sepformer_from_jax_params(tree, PDIMS, "cpu")


def _mix(n, t, seed=0):
    return (np.random.default_rng(seed).standard_normal((n, t))
            .astype(np.float32) * 0.5)


_JAX_SEP = jax.jit(J.sepformer_separate, static_argnums=2)


def _jax_sep(tree, mix, dims=JDIMS):
    return np.asarray(_JAX_SEP(tree, jnp.asarray(mix), dims))


@pytest.mark.parametrize("T", [16, 17, 400, 401, 1237, 3203])
def test_sepformer_matches_jax(weights, T):
    """Odd and even lengths, a single chunk and many: the encoder's VALID
    conv, chunking, the overlap-add and the decoder's crop and re-pad."""
    tree, model = weights
    mix = _mix(3, T, seed=T)
    ours = P.sepformer_separate(model, torch.from_numpy(mix)).numpy()
    ref = _jax_sep(tree, mix)
    assert ours.shape == ref.shape == (3, T, 2)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_module_forward_is_sepformer_separate(weights):
    _, model = weights
    mix = torch.from_numpy(_mix(2, 333))
    assert torch.equal(model(mix), P.sepformer_separate(model, mix))
    one = P.sepformer_separate(model, mix[0])
    assert one.shape == (1, 333, 2)


@pytest.mark.parametrize("T,K", [(7, 10), (10, 10), (23, 10), (250, 250),
                                 (1001, 250), (64, 8)])
def test_chunk_unchunk_round_trip_and_match_jax(T, K):
    """unchunk(chunk(x)) is x (coverage-weighted averaging of identical
    copies), and both halves equal the JAX package's."""
    x = np.random.default_rng(T).standard_normal((2, T, 3)).astype(np.float32)
    chunks, t = P._chunk(torch.from_numpy(x), K)
    jchunks, jt = J._chunk(jnp.asarray(x), K)
    assert t == jt == T
    np.testing.assert_array_equal(chunks.numpy(), np.asarray(jchunks))
    np.testing.assert_allclose(P._unchunk(chunks, T).numpy(), x, rtol=1e-6)
    y = np.random.default_rng(1).standard_normal(chunks.shape).astype(np.float32)
    np.testing.assert_allclose(P._unchunk(torch.from_numpy(y), T).numpy(),
                               np.asarray(J._unchunk(jnp.asarray(y), T)),
                               rtol=1e-6, atol=1e-7)


def test_single_row_equals_its_batched_result(weights):
    _, model = weights
    mix = torch.from_numpy(_mix(4, 801, seed=3))
    batched = P.sepformer_separate(model, mix)
    for i in range(4):
        row = P.sepformer_separate(model, mix[i:i + 1])
        np.testing.assert_allclose(row.numpy(), batched[i:i + 1].numpy(),
                                   rtol=1e-5, atol=1e-6)


def _sb_triplet(seed, dims):
    """A random ckpt triplet in the converter's torch layouts (encoder
    Conv1d [N, 1, L]; masknet Linears [out, in] and LayerNorms; decoder
    ConvTranspose1d [N, 1, L]) — the resepformer-ft format."""
    from test_speaker_golden import _make_sepformer_sds
    return _make_sepformer_sds(np.random.default_rng(seed), dims)


def test_speechbrain_triplet_through_both_converters():
    enc_sd, mask_sd, dec_sd = _sb_triplet(11, JDIMS)
    jtree = _np_tree(J.convert_speechbrain_sepformer(enc_sd, mask_sd, dec_sd,
                                                     JDIMS))
    ptree = P.convert_speechbrain_sepformer(enc_sd, mask_sd, dec_sd, PDIMS)
    for (kp, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jtree)[0],
            jax.tree_util.tree_flatten_with_path(ptree)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(kp))
    assert P.infer_sepformer_dims(ptree, PDIMS) == PDIMS
    model = P.sepformer_from_jax_params(ptree, PDIMS, "cpu")
    # The module's weights are the triplet itself (decoder unflipped).
    assert torch.equal(model.decoder.conv_tr.weight, dec_sd["conv_tr.weight"])
    assert torch.equal(model.encoder.conv1d.weight, enc_sd["conv1d.weight"])
    mix = _mix(2, 400, seed=11)
    np.testing.assert_allclose(
        P.sepformer_separate(model, torch.from_numpy(mix)).numpy(),
        _jax_sep(jtree, mix), rtol=RTOL, atol=ATOL)


def test_state_dicts_round_trip_like_jax(weights):
    tree, model = weights
    ours = P.sepformer_to_state_dicts(tree)
    ref = J.sepformer_to_state_dicts(tree)
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    enc_sd, mask_sd, dec_sd = ours
    assert {k: v.shape for k, v in model.masknet.state_dict().items()} == \
        {k: tuple(np.shape(v)) for k, v in mask_sd.items()}


def test_unrecognized_masknet_naming_warns(caplog):
    enc_sd, _, dec_sd = _sb_triplet(2, JDIMS)
    with caplog.at_level(logging.WARNING):
        tree = P.convert_speechbrain_sepformer(
            enc_sd, {"dual_mdl.0.weight": np.zeros(3)}, dec_sd, PDIMS)
    assert any("unrecognized naming" in r.getMessage() for r in caplog.records)
    np.testing.assert_array_equal(
        tree["encoder"]["w"], enc_sd["conv1d.weight"].numpy().transpose(2, 1, 0))


def test_load_sepformer_from_resepformer_ft_dir(tmp_path):
    """A resepformer-ft/ triplet written with the JAX package's
    sepformer_to_state_dicts loads through the port's staged loader; the
    dims come from the shapes, heads and chunk size from the defaults."""
    dims = J.SepformerDims(enc_channels=16, enc_kernel=8, d_model=16,
                           n_heads=8, ff_mult=2, chunk_size=250, n_repeats=1,
                           n_intra_layers=1, n_inter_layers=2)
    tree = _np_tree(J.init_sepformer_params(jax.random.PRNGKey(13), dims))
    ft = tmp_path / "resepformer-ft"
    ft.mkdir()
    for name, sd in zip(("encoder.ckpt", "masknet.ckpt", "decoder.ckpt"),
                        J.sepformer_to_state_dicts(tree)):
        torch.save({k: torch.tensor(np.asarray(v)) for k, v in sd.items()},
                   str(ft / name))
    b = ModelBundle(torch_config=TorchConfig(), model_dir=str(tmp_path),
                    device="cpu")
    b.load_source = {}
    model = b._load_sepformer()
    assert b.load_source["sepformer"] == "checkpoint"
    assert model.dims == P.SepformerDims(**dataclasses.asdict(dims))
    mix = _mix(2, 2001, seed=13)
    np.testing.assert_allclose(
        P.sepformer_separate(model, torch.from_numpy(mix)).numpy(),
        _jax_sep(tree, mix, dims), rtol=RTOL, atol=ATOL)


def test_load_sepformer_without_checkpoint_is_seeded_init(tmp_path):
    b = ModelBundle(torch_config=TorchConfig(), model_dir=str(tmp_path),
                    device="cpu")
    b.load_source = {}
    a, c = b._load_sepformer(), b._load_sepformer()
    assert b.load_source["sepformer"] == "random_init"
    assert a.dims == P.SepformerDims()
    for (k, x), (_, y) in zip(a.state_dict().items(), c.state_dict().items()):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("n", [1, 3, 4])
def test_separate_batch_pads_rows_and_matches_jax(weights, n):
    """The bundle pads rows to the power-of-two bucket on the device and
    hands back host f32 [n, T, 2], equal to the JAX bundle's."""
    from clearconverse_tpu.config import Config as JConfig, TPUConfig
    from clearconverse_tpu.pipeline.bundle import ModelBundle as JBundle

    tree, model = weights
    tb = ModelBundle(torch_config=TorchConfig(), device="cpu")
    tb._sepformer, tb._loaded = model, True
    jb = JBundle(JConfig(), TPUConfig())
    jb._sepformer, jb._sepformer_dims, jb._loaded = tree, JDIMS, True
    mix = _mix(n, 1500, seed=n)
    seen = []
    orig = P.sepformer_separate

    def spy(m, x):
        seen.append(tuple(x.shape))
        return orig(m, x)

    import clearconverse_tpu_torch.models.resepformer as rsf
    rsf.sepformer_separate = spy
    try:
        ours = tb.separate_batch(mix)
    finally:
        rsf.sepformer_separate = orig
    assert seen == [(1 << (n - 1).bit_length(), 1500)]
    assert ours.dtype == np.float32 and ours.shape == (n, 1500, 2)
    np.testing.assert_allclose(ours, jb.separate_batch(mix), rtol=RTOL,
                               atol=ATOL)
    assert tb.stage_times["separate_dev"] > 0
