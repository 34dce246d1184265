"""Port Whisper fine-tuning against the JAX package (f32, CPU, one torch
thread), at the TINY dims of tests/test_parallel_train.py: the loss sums
and every gradient, one optimizer update (atol 1e-6, as JAX's own tests),
gradient accumulation and remat against the plain step, the loss mask, the
clip rule, K2's autograd Function against jax.grad through the Pallas
kernel's custom VJP, checkpoints, and both fine-tune CLIs on one tiny model
directory."""

import contextlib
import io
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from clearconverse_tpu.models.whisper import WhisperDims as JDims
from clearconverse_tpu.models.whisper import init_whisper_params
from clearconverse_tpu.train import finetune as jft

from clearconverse_tpu_torch.models.convert import whisper_from_jax_params
from clearconverse_tpu_torch.models.whisper import WhisperDims
from clearconverse_tpu_torch.train import finetune as tft

KW = dict(n_mels=16, n_vocab=64, n_audio_ctx=16, n_audio_state=32,
          n_audio_head=4, n_audio_layer=1, n_text_ctx=16, n_text_state=32,
          n_text_head=4, n_text_layer=1)
TINY, JTINY = WhisperDims(**KW), JDims(**KW)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray,
                        init_whisper_params(jax.random.PRNGKey(0), JTINY))


def _model(params):
    return tft.trainable_whisper(whisper_from_jax_params(params, TINY, "cpu"))


def _batch(b=8, L=6, seed=0, pad_from=4):
    """Random mel, tokens and targets; rows are padded (mask 0) from
    ``pad_from`` on, the odd rows one token earlier."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, L), np.float32)
    mask[:, pad_from:] = 0.0
    mask[1::2, pad_from - 1:] = 0.0
    return {"mel": rng.standard_normal((b, 16, 32)).astype(np.float32),
            "tokens": rng.integers(0, 64, (b, L)).astype(np.int32),
            "targets": rng.integers(0, 64, (b, L)).astype(np.int32),
            "loss_mask": mask}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _as_module(tree):
    """A JAX pytree (parameters or gradients) as the port's names."""
    return dict(whisper_from_jax_params(jax.tree.map(np.asarray, tree), TINY,
                                        "cpu").named_parameters())


def test_loss_sums_and_every_gradient_match_jax(params):
    batch = _batch()
    (s, (n, c)), g = jax.value_and_grad(jft.whisper_loss_sums, has_aux=True)(
        params, _j(batch), JTINY, jnp.float32)
    model = _model(params)
    ts, (tn, tc) = tft.whisper_loss_sums(model, _t(batch), TINY,
                                         torch.float32)
    ts.backward()
    np.testing.assert_allclose(float(ts.detach()), float(s), rtol=1e-6)
    assert (float(tn), float(tc)) == (float(n), float(c))
    ref = _as_module(g)
    for name, p in model.named_parameters():
        # Every parameter gets a gradient, the decoder's through the
        # in-place self-KV cache writes too.
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].detach().numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert all(float(p.grad.abs().max()) > 0
               for name, p in model.named_parameters()
               if name.startswith("decoder.blocks"))


def test_whisper_loss_matches_jax(params):
    batch = _batch(seed=1)
    loss, m = jft.whisper_loss(params, _j(batch), JTINY, jnp.float32)
    tloss, tm = tft.whisper_loss(_model(params), _t(batch), TINY,
                                 torch.float32)
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-6)
    np.testing.assert_allclose(float(tm["accuracy"]), float(m["accuracy"]),
                               rtol=1e-6)


def _jax_step(params, batch, steps=1, lr=1e-5, accum_steps=1):
    opt = jft.default_optimizer(lr=lr)
    state = jft.init_train_state(params, opt)
    step = jft.make_train_step(JTINY, opt, compute_dtype=jnp.float32,
                               accum_steps=accum_steps)
    p, o, s = state.params, state.opt_state, state.step
    for _ in range(steps):
        p, o, s, m = step(p, o, _j(batch), s)
    return p, m


def _torch_step(params, batch, steps=1, lr=1e-5, **kw):
    model = _model(params)
    state = tft.init_train_state(model, tft.default_optimizer(
        model.parameters(), lr=lr))
    step = tft.make_train_step(TINY, compute_dtype=torch.float32, **kw)
    for _ in range(steps):
        m = step(state, _t(batch))
    assert state.step == steps
    return state, m


def _params_close(model, ref, atol):
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].detach().numpy(),
                                   rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_jax(params, steps):
    """AdamW after the global-norm clip (the clip triggers: the first
    gradient's norm is far above 1), parameters within 1e-6."""
    batch = _batch(seed=2)
    jp, jm = _jax_step(params, batch, steps)
    state, tm = _torch_step(params, batch, steps)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    _params_close(state.model, _as_module(jp), atol=1e-6)


def test_accumulation_equals_full_batch(params):
    batch = _batch(seed=3)
    full, fm = _torch_step(params, batch)
    acc, am = _torch_step(params, batch, accum_steps=4)
    np.testing.assert_allclose(float(am["loss"]), float(fm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(am["accuracy"]), float(fm["accuracy"]))
    _params_close(acc.model, dict(full.model.named_parameters()), atol=1e-6)
    # And against the JAX package's lax.scan accumulation.
    jp, _ = _jax_step(params, batch, accum_steps=4)
    _params_close(acc.model, _as_module(jp), atol=1e-6)


def test_remat_equals_plain(params):
    batch = _batch(seed=4)
    plain, pm = _torch_step(params, batch, steps=2)
    remat, rm = _torch_step(params, batch, steps=2, remat=True,
                            accum_steps=2)
    np.testing.assert_allclose(float(rm["loss"]), float(pm["loss"]),
                               rtol=1e-6)
    _params_close(remat.model, dict(plain.model.named_parameters()),
                  atol=1e-6)


def test_loss_mask_zeroes_padding(params):
    """Targets and tokens behind the mask change neither the loss nor any
    gradient."""
    a = _batch(seed=5)
    b = {k: v.copy() for k, v in a.items()}
    rng = np.random.default_rng(9)
    hidden = a["loss_mask"] == 0
    b["targets"][hidden] = rng.integers(0, 64, int(hidden.sum()))
    b["tokens"][hidden] = rng.integers(0, 64, int(hidden.sum()))
    grads = []
    for batch in (a, b):
        model = _model(params)
        loss, _ = tft.whisper_loss(model, _t(batch), TINY, torch.float32)
        loss.backward()
        grads.append((float(loss.detach()), [p.grad.clone()
                                    for p in model.parameters()]))
    assert grads[0][0] == grads[1][0]
    for ga, gb in zip(grads[0][1], grads[1][1]):
        assert torch.equal(ga, gb)
    empty = dict(_t(a), loss_mask=torch.zeros(8, 6))
    loss, m = tft.whisper_loss(_model(params), empty, TINY, torch.float32)
    assert float(loss.detach()) == 0.0 and float(m["accuracy"]) == 0.0


def test_indivisible_batch_raises(params):
    model = _model(params)
    step = tft.make_train_step(TINY, compute_dtype=torch.float32,
                               accum_steps=3)
    with pytest.raises(ValueError, match="batch 8 not divisible by "
                                         "accum_steps=3"):
        step(tft.init_train_state(model), _t(_batch()))


def test_model_learns_a_fixed_batch(params):
    batch = _batch(seed=6)
    model = _model(params)
    state = tft.init_train_state(model, tft.default_optimizer(
        model.parameters(), lr=1e-3))
    step = tft.make_train_step(TINY, compute_dtype=torch.float32)
    first = float(step(state, _t(batch))["loss"])
    for _ in range(10):
        last = float(step(state, _t(batch))["loss"])
    assert last < first and state.step == 11


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["below", "above"])
def test_clip_follows_optax(scale):
    """g / norm * clip once the global norm reaches the clip, untouched
    below it (optax.clip_by_global_norm)."""
    rng = np.random.default_rng(7)
    grads = [rng.standard_normal(s).astype(np.float32) * scale
             for s in ((3, 4), (5,), (2, 2, 2))]
    ref, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(ps, grads):
        p.grad = torch.from_numpy(g.copy())
    opt = tft.ClippedAdamW(ps, 1.0, lr=0.0, weight_decay=0.0)
    opt.step()
    for p, r in zip(ps, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6)


def test_k2_backward_matches_jax_custom_vjp():
    """The autograd Function's backward (the plain attention recomputed)
    against jax.grad through encoder_attention_pallas in interpret mode, at
    tests/test_pallas.py:64's shapes and tolerance."""
    from clearconverse_tpu.ops.pallas.encoder_attention import (
        encoder_attention_pallas)
    from clearconverse_tpu_torch.ops.encoder_attention import encoder_attention

    rng = np.random.default_rng(0)
    B, T, D, H = 1, 300, 256, 4
    qkv = [rng.standard_normal((B, T, D)).astype(np.float32) * 0.3
           for _ in range(3)]

    def loss_pallas(q, k, v):
        return jnp.sum(encoder_attention_pallas(q, k, v, H, True) ** 2)

    g_ref = jax.grad(loss_pallas, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in qkv))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in qkv]
    out = encoder_attention(*ts, H)
    assert type(out.grad_fn).__name__ == "_EncoderAttentionBackward"
    (out ** 2).sum().backward()
    for t, r in zip(ts, g_ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-4)
    with torch.no_grad():
        assert encoder_attention(*ts, H).grad_fn is None


def test_checkpoint_round_trip_resumes(params, tmp_path):
    """Saved params, optimizer state and step load back and resume to the
    same next step as the uninterrupted run."""
    from clearconverse_tpu_torch.train.checkpoint import (
        load_checkpoint, save_checkpoint)
    batch = _t(_batch(seed=8))
    step = tft.make_train_step(TINY, compute_dtype=torch.float32)
    state, _ = _torch_step(params, _batch(seed=8), steps=2)
    path = str(tmp_path / "ck" / "train.pt")
    save_checkpoint(path, state.model, state.optimizer.state_dict(),
                    state.step)
    ck = load_checkpoint(path)
    assert ck["step"] == 2
    model = _model(params)
    model.load_state_dict(ck["params"])
    resumed = tft.init_train_state(model, tft.default_optimizer(
        model.parameters()))
    resumed.optimizer.load_state_dict(ck["opt_state"])
    resumed.step = ck["step"]
    step(state, batch)
    step(resumed, batch)
    for a, b in zip(state.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)


def test_both_train_clis_on_one_model_dir(tmp_path):
    """python -m clearconverse_tpu.train and python -m
    clearconverse_tpu_torch.train --device cpu on the same tiny checkpoint
    and pairs (tiny, 2 steps, bf16 compute as both default): the step-0
    losses agree within 1e-2 relative (bf16 rounds each product's inputs to
    8 bits of mantissa), both losses fall, and the JAX loader reads the
    port's overlay to the arrays the port's loader reads."""
    from clearconverse_tpu.audio.wav import write_wav
    from clearconverse_tpu.models.convert import load_torch_state_dict as jload
    from clearconverse_tpu.models.whisper import model_dims
    from clearconverse_tpu.train.__main__ import main as jmain
    from clearconverse_tpu.train.checkpoint import export_whisper_pt
    from clearconverse_tpu_torch.models.convert import (
        load_torch_state_dict, load_whisper)
    from clearconverse_tpu_torch.train.__main__ import main as tmain
    from clearconverse_tpu_torch.train.checkpoint import (
        whisper_to_openai_state_dict)

    models = tmp_path / "models"
    models.mkdir()
    dims = model_dims("tiny")
    export_whisper_pt(init_whisper_params(jax.random.PRNGKey(0), dims), dims,
                      str(models / "tiny.pt"))
    pairs = tmp_path / "pairs"
    pairs.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        write_wav(str(pairs / f"ex{i}.wav"),
                  (rng.standard_normal(3 * 16000) * 0.1).astype(np.float32),
                  16000)
        (pairs / f"ex{i}.txt").write_text("hello world")
    losses = {}
    for name, main, extra in (("jax", jmain, []),
                              ("torch", tmain, ["--device", "cpu"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(["--data_dir", str(pairs), "--model", "tiny",
                       "--steps", "2", "--batch", "2", "--max_tokens", "8",
                       "--export", str(tmp_path / name),
                       "--model_dir", str(models)] + extra)
        assert rc == 0
        lines = out.getvalue().splitlines()
        losses[name] = [float(line.split("loss=")[1].split()[0])
                        for line in lines if "loss=" in line]
        assert lines[0] == "2 training pairs"
        assert lines[-1].startswith("whisper-ft overlay → ")
    for run in losses.values():
        assert len(run) == 2 and run[1] < run[0]
    np.testing.assert_allclose(losses["torch"][0], losses["jax"][0],
                               rtol=1e-2)
    overlay = str(tmp_path / "torch" / "whisper-ft" / "model.safetensors")
    ours, ref = load_torch_state_dict(overlay), jload(overlay)
    assert ours.keys() == ref.keys()
    for k in ours:
        np.testing.assert_array_equal(np.asarray(ref[k]), ours[k])
    # The port's loader takes the overlay over the base checkpoint.
    ft_dir = tmp_path / "ft_models"
    ft_dir.mkdir()
    os.symlink(models / "tiny.pt", ft_dir / "tiny.pt")
    os.symlink(tmp_path / "torch" / "whisper-ft", ft_dir / "whisper-ft")
    model, _ = load_whisper(str(ft_dir), "tiny", "cpu")
    for k, v in whisper_to_openai_state_dict(model).items():
        np.testing.assert_array_equal(v, ours[k], err_msg=k)
