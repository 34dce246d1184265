"""The port's (data, model) mesh against its own 1x1 run and the JAX
package's meshed run (f32, CPU ranks over gloo, one torch thread each).

One group of eight spawned CPU ranks runs every mesh check once
(tests/torch_mesh_worker.mesh_checks): transcribe_batch at t=0 on the 4x2,
8x1, 2x4 and 1x8 meshes of tests/test_multichip_serving.py (tokens and texts
identical to the port's 1x1 call and to JAX's meshed bundle), t=0.7 with
best_of on the data axis, embed / separate / segment and the engine
wavefront at 4x2, the int8 cross-KV codes of a head shard, an int8 decoder
at 1x8, and the fine-tune step at 4x2 against the port's 1x1 step and
JAX's sharded step. The weights are the JAX package's, carried over; the
tolerances are the reference's (tests/test_multichip_serving.py,
tests/test_parallel_train.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import torch_mesh_worker as W

from clearconverse_tpu.config import Config as JConfig
from clearconverse_tpu.config import TPUConfig
from clearconverse_tpu.models.ecapa import EcapaDims as JEcapaDims
from clearconverse_tpu.models.ecapa import init_ecapa_params
from clearconverse_tpu.models.pyannet import PyannetDims as JPyannetDims
from clearconverse_tpu.models.pyannet import init_pyannet_params
from clearconverse_tpu.models.resepformer import SepformerDims as JSepDims
from clearconverse_tpu.models.resepformer import init_sepformer_params
from clearconverse_tpu.models.tokenizer import ByteFallbackTokenizer as JTok
from clearconverse_tpu.models.whisper import WhisperDims as JDims
from clearconverse_tpu.models.whisper import init_whisper_params
import clearconverse_tpu.pipeline.bundle as jbundle_mod
from clearconverse_tpu.pipeline.bundle import ModelBundle as JBundle

from clearconverse_tpu_torch.config import TorchConfig, torch_config_from_env
from clearconverse_tpu_torch.models.convert import whisper_from_jax_params
from clearconverse_tpu_torch.models.whisper import (
    WhisperDims, precompute_cross_kv)
from clearconverse_tpu_torch.ops.quantize import quantize_whisper_decoder
from clearconverse_tpu_torch.parallel.launch import run_group
from clearconverse_tpu_torch.parallel.mesh import build_mesh
from clearconverse_tpu_torch.parallel.sharding import (
    param_split, whisper_param_spec)
from clearconverse_tpu_torch.train.finetune import trainable_whisper

ECAPA = dict(n_mels=24, channels=32, mfa_channels=48, attention_channels=16,
             embedding_dim=16, res2net_scale=4)
SEP = dict(enc_channels=16, d_model=16, n_heads=2, chunk_size=20,
           n_repeats=1, n_intra_layers=1, n_inter_layers=1)
PYANNET = dict(sinc_filters=8, conv_channels=8, lstm_hidden=8,
               lstm_layers=1, linear_dims=(8,))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def trees():
    return {
        "whisper": _np(init_whisper_params(jax.random.PRNGKey(0),
                                           JDims(**W.WHISPER_KW))),
        "ecapa": _np(init_ecapa_params(jax.random.PRNGKey(1),
                                       JEcapaDims(**ECAPA))),
        "ecapa_dims": ECAPA,
        "sepformer": _np(init_sepformer_params(jax.random.PRNGKey(2),
                                               JSepDims(**SEP))),
        "sepformer_dims": SEP,
        "pyannet": _np(init_pyannet_params(jax.random.PRNGKey(3),
                                           JPyannetDims(**PYANNET))),
        "pyannet_dims": PYANNET,
        "train": _np(init_whisper_params(jax.random.PRNGKey(0),
                                         JDims(**W.TRAIN_KW))),
    }


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    b = rng.standard_normal((8, 16, 32)).astype(np.float32)
    return {
        "audio": rng.standard_normal((3, 8000)).astype(np.float32) * 0.1,
        "prompts": ["", "ctx", ""],
        "clips": [rng.standard_normal(12000).astype(np.float32) * 0.1,
                  rng.standard_normal(8000).astype(np.float32) * 0.1],
        "speaker_audio": rng.standard_normal((2, 8000)).astype(np.float32)
        * 0.1,
        "speaker_lens": np.asarray([8000, 4000]),
        "features": rng.standard_normal((2, 50, 64)).astype(np.float32),
        "train_batch": {
            "mel": b,
            "tokens": rng.integers(0, 64, (8, 6)).astype(np.int32),
            "targets": rng.integers(0, 64, (8, 6)).astype(np.int32),
            "loss_mask": np.ones((8, 6), np.float32)},
        "whisper_train_batch": {
            "mel": rng.standard_normal((2, 80, 3000)).astype(np.float32),
            "tokens": rng.integers(0, 51864, (2, 6)).astype(np.int32),
            "targets": rng.integers(0, 51864, (2, 6)).astype(np.int32),
            "loss_mask": np.ones((2, 6), np.float32)},
    }


@pytest.fixture(scope="module")
def ranks(trees, inputs):
    """Every mesh check, once, on eight CPU ranks."""
    return run_group(W.mesh_checks, ["cpu"] * 8, args=(trees, inputs),
                     timeout_s=600)


@pytest.fixture(scope="module")
def single(trees, inputs):
    """The port at 1x1 in this process."""
    torch.set_num_threads(1)
    out = {"transcribe": W.transcribe(W.port_bundle(trees), inputs),
           "sampled": W.transcribe(W.port_bundle(trees, best_of=2), inputs,
                                   temperature=0.7),
           "speaker": W.speaker_half(W.port_bundle(trees), inputs),
           "wavefront": W.wavefront(W.port_bundle(trees), inputs)}
    dims = WhisperDims(**W.WHISPER_KW)
    whole = whisper_from_jax_params(trees["whisper"], dims, "cpu")
    out["aligned"] = W.alignment(whole, inputs)
    out["native"] = W.native_whisper(W.port_bundle(trees))
    out["cross_kv"] = precompute_cross_kv(
        whole, torch.from_numpy(inputs["features"]), dims.n_text_head, bits=8)
    b = W.port_bundle(trees)
    b._whisper = (quantize_whisper_decoder(whole), dims, b._whisper[2])
    out["quantized"] = W.transcribe(b, inputs)
    tdims = WhisperDims(**W.TRAIN_KW)
    out["train"] = W.train_step(trainable_whisper(whisper_from_jax_params(
        trees["train"], tdims, "cpu")), inputs["train_batch"])
    out["train_gathered"] = W.train_step(
        trainable_whisper(whisper_from_jax_params(trees["whisper"], dims,
                                                  "cpu")),
        inputs["whisper_train_batch"], dims_kw=W.WHISPER_KW)
    return out


def _jax_bundle(trees, data, model):
    from clearconverse_tpu.models.ecapa import EcapaDims
    from clearconverse_tpu.models.pyannet import PyannetDims
    from clearconverse_tpu.models.resepformer import SepformerDims
    b = JBundle(JConfig(), TPUConfig(max_decode_tokens=8,
                                     compute_dtype="float32",
                                     data_axis=data, model_axis=model))
    b._whisper = (jax.tree.map(jnp.asarray, trees["whisper"]),
                  JDims(**W.WHISPER_KW), JTok(english=True))
    b._ecapa, b._ecapa_dims = trees["ecapa"], EcapaDims(**ECAPA)
    b._sepformer, b._sepformer_dims = trees["sepformer"], SepformerDims(**SEP)
    b._pyannet, b._pyannet_dims = trees["pyannet"], PyannetDims(**PYANNET)
    b._loaded = True
    return b


def _jax_transcribe(trees, inputs, data, model):
    b = _jax_bundle(trees, data, model)
    assert b.mesh.shape == {"data": data, "model": model}
    with W.recorded_decodes(jbundle_mod) as calls:
        texts = b.transcribe_batch(inputs["audio"], inputs["prompts"],
                                   temperature=0.0)
    return texts, np.asarray(calls[-1][0])[:3]


# ------------------------------------------------------------------ mesh

def test_build_mesh_shapes_and_errors(ranks):
    """tests/test_parallel_train.py's shapes on eight ranks: rank 0 sits at
    (0, 0); data=-1 absorbs the rest; 3x3 and an indivisible -1x3 raise."""
    assert ranks["mesh"][(4, 2)] == ({"data": 4, "model": 2}, 0, 0)
    assert ranks["mesh"][(-1, 2)][0] == {"data": 4, "model": 2}
    assert ranks["mesh"][(8, 1)][0] == {"data": 8, "model": 1}
    assert len(ranks["mesh_errors"]) == 2
    assert "needs 9 ranks" in ranks["mesh_errors"][0]
    assert "not divisible by model=3" in ranks["mesh_errors"][1]


def test_mesh_needs_a_process_group():
    """No silent 1x1: without a process group a mesh raises, and so does a
    bundle whose TorchConfig asks for one."""
    with pytest.raises(RuntimeError, match="process group"):
        build_mesh(2, 1)
    b = W.port_bundle(_tiny_trees(), 2, 1)
    with pytest.raises(RuntimeError, match="process group"):
        b.transcribe_batch(np.zeros((2, 8000), np.float32), ["", ""])


def _tiny_trees():
    return {"whisper": _np(init_whisper_params(jax.random.PRNGKey(0),
                                               JDims(**W.WHISPER_KW)))}


def test_torch_config_mesh_axes_from_env():
    t = torch_config_from_env({"CC_TORCH_DATA_AXIS": "4",
                               "CC_TORCH_MODEL_AXIS": "2"})
    assert (t.data_axis, t.model_axis) == (4, 2)
    d = torch_config_from_env({})
    assert (d.data_axis, d.model_axis) == (1, 1) == (
        TorchConfig().data_axis, TorchConfig().model_axis)


def test_param_spec_splits_megatron_layers():
    """q/k/v/fc1 split on dim 0 (weight and bias), out/fc2 on dim 1 (weight
    only), every other parameter replicated."""
    model = whisper_from_jax_params(_tiny_trees()["whisper"],
                                    WhisperDims(**W.WHISPER_KW), "cpu")
    spec = whisper_param_spec(model)
    assert set(spec) == {n for n, _ in model.named_parameters()}
    assert spec["encoder.blocks.0.attn.q.bias"] == 0
    assert spec["decoder.blocks.0.cross.k.weight"] == 0
    assert spec["decoder.blocks.0.mlp.fc2.weight"] == 1
    assert spec["decoder.blocks.0.mlp.fc2.bias"] is None
    assert spec["decoder.tok"] is None and spec["encoder.conv1.weight"] is None
    assert param_split("decoder.blocks.0.attn.out.wq") == 1
    assert param_split("decoder.blocks.0.attn.out.scale") is None
    # Encoder block: q, v (weight, bias), k, out, fc1 (weight, bias), fc2;
    # decoder block: that, with the cross-attention's six too.
    assert sum(v is not None for v in spec.values()) == 9 + 15


# ------------------------------------------------------------- serving

@pytest.mark.parametrize("data,model", W.MESHES,
                         ids=[f"{d}x{m}" for d, m in W.MESHES])
def test_transcribe_batch_mesh_equals_single_and_jax(data, model, ranks,
                                                     single, trees, inputs):
    texts, tokens, lengths = ranks["transcribe"][(data, model)]
    s_texts, s_tokens, s_lengths = single["transcribe"]
    assert texts == s_texts
    np.testing.assert_array_equal(tokens, s_tokens)
    np.testing.assert_array_equal(lengths, s_lengths)
    j_texts, j_tokens = _jax_transcribe(trees, inputs, data, model)
    assert texts == j_texts
    np.testing.assert_array_equal(tokens, j_tokens)


@pytest.mark.parametrize("data,model", [(4, 2), (1, 8)],
                         ids=["4x2-heads-split", "1x8-heads-gathered"])
def test_shard_replaces_the_whole_model_and_aligns_as_single(
        data, model, ranks, single):
    """After a transcribe_batch with word timestamps a rank holds its
    Whisper shard in place of the whole model (q 64 // model rows wide).
    On the shard, the alignment's cross-attention weights lie within 1e-6
    of the whole model's, and word timestamps and detected languages equal
    them."""
    got, want = ranks["aligned"][(data, model)], single["aligned"]
    assert got["sharded"]
    assert got["q_width"] == W.WHISPER_KW["n_audio_state"] // model
    np.testing.assert_allclose(got["attn"], want["attn"], rtol=0, atol=1e-6)
    assert [w["word"] for w in want["words"][0]] == ["ab", "cd"]
    assert got["words"] == want["words"]
    np.testing.assert_array_equal(got["languages"], want["languages"])


def test_save_native_of_a_sharded_bundle_is_the_whole_model(ranks, single):
    """save_native on a 1x8 bundle holding its shard writes the whole
    Whisper, equal to the 1x1 bundle's file."""
    got, want = ranks["native"], single["native"]
    assert got.keys() == want.keys()
    for name, t in want.items():
        np.testing.assert_array_equal(got[name], t, err_msg=name)


def test_sampled_transcribe_on_data_axis_equals_single(ranks, single):
    """t=0.7 with best_of 2 at 4x2: every data rank draws the noise of the
    whole batch and keeps its rows, so the samples are the 1x1 ones."""
    texts, tokens, _ = ranks["sampled"]
    s_texts, s_tokens, _ = single["sampled"]
    assert texts == s_texts
    np.testing.assert_array_equal(tokens, s_tokens)


def test_embed_separate_segment_mesh_equals_single(ranks, single, trees,
                                                   inputs):
    jb = _jax_bundle(trees, 4, 2)
    audio, lens = inputs["speaker_audio"], inputs["speaker_lens"]
    ref = {"embed": jb.embed_batch(audio, lens),
           "separate": jb.separate_batch(audio),
           "segment": jb.segment_frames(audio)}
    for key in ("embed", "separate", "segment"):
        np.testing.assert_allclose(ranks["speaker"][key],
                                   single["speaker"][key],
                                   rtol=1e-4, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(ranks["speaker"][key], ref[key],
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_published_separator_lengths_mesh_equals_single(ranks, single,
                                                        inputs):
    """The published layout's lengths travel with their rows to every data
    rank (rows of the row bucket with length 0 give zeros)."""
    got = ranks["speaker"]["separate_lengths"]
    np.testing.assert_allclose(got, single["speaker"]["separate_lengths"],
                               rtol=1e-4, atol=1e-5)
    n = inputs["speaker_lens"][1]
    assert np.count_nonzero(got[1, n:]) == 0
    assert np.count_nonzero(got[1, :n]) > 0


def test_engine_wavefront_mesh_equals_single(ranks, single, trees, inputs):
    """Rank 0's engine wavefront, its calls followed by the other seven
    ranks, gives the 1x1 texts and JAX's 4x2 texts."""
    from clearconverse_tpu.pipeline.engine import (
        TranscriptionEngine as JEngine)
    jb = _jax_bundle(trees, 4, 2)
    eng = JEngine(JConfig(temperature=0.0), jb.tpu, models=jb)
    c0, c1 = inputs["clips"]
    items = [dict(audio=c0, prompt="", depends_on=None, start=0.0, end=0.75,
                  speaker="SPEAKER_A"),
             dict(audio=c1, prompt=None, depends_on=0, start=0.8, end=1.3,
                  speaker="SPEAKER_A")]
    eng._transcribe_wavefront(items, 16000)
    assert ranks["wavefront"] == single["wavefront"]
    assert ranks["wavefront"] == [it["text"] for it in items]


def test_int8_cross_kv_codes_of_a_head_shard(ranks, single):
    """_quant_kv scales each d-channel over T, so the codes and scales of a
    head shard, gathered over the model axis, are the 1x1 ones exactly."""
    for got, want in zip(ranks["cross_kv"], single["cross_kv"]):
        for name in ("k8t", "v8t"):
            for key in ("q", "scale"):
                np.testing.assert_array_equal(got[name][key],
                                              want[name][key].numpy())


def test_quantized_decoder_on_a_mesh_equals_single(ranks, single):
    """An int8 decoder sharded 1x8 (its heads gathered) decodes the 1x1
    int8 decoder's tokens."""
    assert ranks["quantized"][0] == single["quantized"][0]
    np.testing.assert_array_equal(ranks["quantized"][1],
                                  single["quantized"][1])


# ------------------------------------------------------------- training

def _check_train_step(got, want, tree, dims_kw, batch, data, model,
                      clear_of_zero=False):
    """A sharded step's (loss, grads, params) against the 1x1 step's and
    JAX's step on the same ``data`` x ``model`` mesh: loss within rtol 1e-4
    of both; every gradient within 1e-4 of the largest entry of the 1x1
    step's; every parameter after the step within 5e-6 of the 1x1 step's
    (with ``clear_of_zero``, those whose 1x1 gradient exceeds 1e-3 of its
    parameter's largest: AdamW's first step g / (|g| + eps) turns a
    rounding difference of a near-zero gradient into one of up to 2 lr);
    no parameter with a nonzero 1x1 gradient left at zero."""
    from clearconverse_tpu.parallel.mesh import build_mesh as jbuild_mesh
    from clearconverse_tpu.parallel.sharding import shard_params
    from clearconverse_tpu.train.finetune import (
        default_optimizer, init_train_state, make_train_step)
    loss, grads, params = got
    s_loss, s_grads, s_params = want
    mesh = jbuild_mesh(data=data, model=model)
    with mesh:
        p = shard_params(jax.tree.map(jnp.asarray, tree), mesh)
        opt = default_optimizer(lr=1e-3)
        st = init_train_state(p, opt)
        step = make_train_step(JDims(**dims_kw), opt, mesh=mesh,
                               compute_dtype=jnp.float32)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        _, _, _, m = step(st.params, st.opt_state, jbatch, st.step)
    np.testing.assert_allclose(loss, s_loss, rtol=1e-4)
    np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-4)
    assert set(params) == set(s_params) == set(grads) == set(s_grads)
    top = max(np.abs(g).max() for g in s_grads.values())
    for name in s_params:
        np.testing.assert_allclose(grads[name], s_grads[name], rtol=0,
                                   atol=1e-4 * top, err_msg=name)
        assert params[name].shape == s_params[name].shape, name
        keep = (np.abs(s_grads[name]) > 1e-3 * np.abs(s_grads[name]).max()
                if clear_of_zero else slice(None))
        np.testing.assert_allclose(params[name][keep], s_params[name][keep],
                                   atol=5e-6, err_msg=name)
        if np.abs(s_grads[name]).max() > 0:
            assert np.abs(grads[name]).max() > 0, name


def test_train_step_sharded_matches_single_and_jax(ranks, single, trees,
                                                   inputs):
    """4x2 on four heads: the 1x1 step's and JAX's, to the tolerances of
    ``_check_train_step``."""
    _check_train_step(ranks["train"], single["train"], trees["train"],
                      W.TRAIN_KW, inputs["train_batch"], 4, 2)


def test_train_step_with_gathered_heads_matches_single_and_jax(
        ranks, single, trees, inputs):
    """2x4 on two heads, which do not split over model: q, k and v are
    gathered into whole heads (_Gather, and its backward in the step). The
    1x1 step's and JAX's, to the tolerances of ``_check_train_step``; its
    parameters where the gradient is clear of zero (its 80-mel conv1 has
    gradients within rounding of zero)."""
    _check_train_step(ranks["train_gathered"], single["train_gathered"],
                      trees["whisper"], W.WHISPER_KW,
                      inputs["whisper_train_batch"], 2, 4,
                      clear_of_zero=True)


def test_a_follower_failing_alone_ends_the_mesh():
    """Serving at 1x2 on two CPU ranks: an error met by both ranks reaches
    rank 0's caller and the mesh serves the next call; an error on the
    follower alone, while rank 0 waits in a collective, fails rank 0's
    call within the collective time limit (5 s here), ends the follower,
    and every later call refuses at once."""
    out = run_group(W.follower_faults, ["cpu", "cpu"], timeout_s=120)
    assert out["alike"][0] == "ValueError: bad request"
    texts, _ = out["ok"]
    assert isinstance(texts, list) and len(texts) == 2
    alone, secs = out["alone"]
    assert alone.startswith("RuntimeError: the ranks disagree on "
                            "transcribe_batch"), alone
    assert "rank 1: RuntimeError: injected fault" in alone, alone
    assert secs < 60, secs
    after, secs = out["after"]
    assert after.startswith("RuntimeError: the mesh is down"), after
    assert secs < 1, secs


def test_dryrun_multichip_cpu():
    from clearconverse_tpu_torch.entry import dryrun_multichip
    out = dryrun_multichip(4, device="cpu")
    assert out["mesh"] == (2, 2) and np.isfinite(out["loss"])
    assert any(seg[3] for segs in out["engine"] for seg in segs)


def test_noise_rows_draw_the_whole_batch():
    """A data rank's block decoded with noise_rows samples the tokens of
    the same rows in the whole batch's decode (t > 0)."""
    import dataclasses
    from clearconverse_tpu_torch.models.convert import init_whisper
    from clearconverse_tpu_torch.models.decoding import (
        DecodeOptions, build_prompt_batch, greedy_decode)
    dims = WhisperDims(**W.TRAIN_KW)
    model = init_whisper(dims, 0, "cpu")
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 16, 32)).astype(np.float32))
    toks, lens = build_prompt_batch([[1]] * 4, 1, pad_id=0)
    toks, lens = torch.from_numpy(toks), torch.from_numpy(lens)
    opts = DecodeOptions(max_tokens=6, eot=63, suppress_blank=False,
                         temperature=1.0)

    def run(rows, o):
        gen = torch.Generator().manual_seed(5)
        return greedy_decode(model, mel[rows], toks[rows], lens[rows], dims,
                             o, 1, gen)["tokens"]

    whole = run(slice(0, 4), opts)
    for lo in (0, 2):
        part = run(slice(lo, lo + 2),
                   dataclasses.replace(opts, noise_rows=(lo, 4)))
        torch.testing.assert_close(part, whole[lo:lo + 2], rtol=0, atol=0)


def test_train_cli_mesh_exports_the_whole_model(tmp_path):
    """--mesh 2x2 on four CPU ranks (a launcher's process group): rank 0
    writes the whole model and its AdamW moments, and they match the 1x1
    CLI's run (bf16 compute: within 2.5 lr per entry, where the sign of a
    near-zero gradient may flip)."""
    from clearconverse_tpu_torch.audio.wav import write_wav
    from clearconverse_tpu_torch.train.__main__ import main
    from clearconverse_tpu_torch.train.checkpoint import load_checkpoint
    rng = np.random.default_rng(0)
    pairs = tmp_path / "pairs"
    pairs.mkdir()
    for i in range(4):
        write_wav(str(pairs / f"p{i}.wav"), (rng.standard_normal(
            8000 * (i + 1)) * 0.1).astype(np.float32), 16000)
        (pairs / f"p{i}.txt").write_text(f"hello number {i}")
    common = ["--data_dir", str(pairs), "--model", "tiny", "--model_dir",
              str(tmp_path / "none"), "--steps", "1", "--batch", "2",
              "--max_tokens", "8", "--device", "cpu"]
    assert main(common + ["--checkpoint", str(tmp_path / "a.pt")]) == 0
    assert run_group(W.train_cli, ["cpu"] * 4, args=(
        common + ["--mesh", "2x2", "--checkpoint", str(tmp_path / "b.pt"),
                  "--export", str(tmp_path / "ft")],), timeout_s=300) == 0
    a, b = (load_checkpoint(str(tmp_path / n)) for n in ("a.pt", "b.pt"))
    assert a["step"] == b["step"] == 1
    assert a["params"].keys() == b["params"].keys()
    for name, p in a["params"].items():
        assert b["params"][name].shape == p.shape, name
        torch.testing.assert_close(b["params"][name], p, rtol=0,
                                   atol=2.5e-5, msg=name)
    sa, sb = a["opt_state"]["state"], b["opt_state"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        assert sb[i]["exp_avg"].shape == sa[i]["exp_avg"].shape
    assert (tmp_path / "ft" / "whisper-ft" / "model.safetensors").exists()
