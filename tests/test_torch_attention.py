"""Kernel K2's plain version and the port's plain attention against the JAX
package (CPU; Pallas in interpret mode), on the same numpy inputs: K2
against the Pallas kernel it replaces and against the JAX package's library
flash-attention path, which computes the same function."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from clearconverse_tpu.models.whisper import _flash_attention
from clearconverse_tpu.models.whisper import attention as jattention
from clearconverse_tpu.ops.pallas.encoder_attention import (
    encoder_attention_pallas)

from clearconverse_tpu_torch.models.whisper import attention
from clearconverse_tpu_torch.ops import encoder_attention as k2
from clearconverse_tpu_torch.ops import kernel_variants

B, T, D, H = 2, 300, 256, 4      # T not a multiple of the Pallas 512 block


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _qkv(seed=0, shape=(B, T, D)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) * 0.3
            for _ in range(3)]


# f32 atol 1e-5 and bf16 atol 2e-3: tests/test_pallas.py's tolerances for
# the Pallas kernel against the einsum attention.
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-3)])
def test_k2_plain_matches_pallas(dtype, atol):
    q, k, v = _qkv()
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
    ref = np.asarray(encoder_attention_pallas(jq, jk, jv, H, interpret=True)
                     .astype(jnp.float32))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    ours = k2.encoder_attention_plain(tq, tk, tv, H)
    assert ours.dtype == tdt and ours.shape == (B, T, D)
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=atol)


# The JAX package's library flash-attention path computes K2's function:
# unmasked softmax attention over T, scale dh^-0.5, padded keys masked.
# f32 atol 1e-5, bf16 atol 2e-3 (one bf16 step of the output is 9.8e-4).
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-3)])
def test_k2_matches_jax_flash_attention(dtype, atol):
    rng = np.random.default_rng(3)
    shape = (1, 300, 128)                        # 2 heads of 64
    q, k, v = (rng.standard_normal(shape).astype(np.float32) * scale
               for scale in (1.0, 1.0, 0.3))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_flash_attention(
            *(jnp.asarray(x).astype(dtype) for x in (q, k, v)), 2)
            .astype(jnp.float32))
    tdt = getattr(torch, dtype)
    ours = k2.encoder_attention(*(torch.from_numpy(x).to(tdt)
                                  for x in (q, k, v)), 2)
    assert ours.dtype == tdt and ours.shape == shape
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=atol)


@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_matches_jax(with_bias):
    """models/whisper.attention (q and k each scaled by dh^-0.25), f32,
    atol 1e-5, with and without an additive bias."""
    q, k, v = _qkv(seed=1, shape=(2, 7, 64))
    bias = None
    if with_bias:
        causal = np.triu(np.full((7, 7), -1e9, np.float32), 1)
        bias = np.broadcast_to(causal, (2, 1, 7, 7)).copy()
    ref = np.asarray(jattention(*(jnp.asarray(x) for x in (q, k, v)),
                                None if bias is None else jnp.asarray(bias), 2))
    ours = attention(*(torch.from_numpy(x) for x in (q, k, v)),
                     None if bias is None else torch.from_numpy(bias), 2)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)


def test_cpu_tensors_take_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv(seed=2))
    before = k2.encoder_attention.launches
    np.testing.assert_array_equal(
        k2.encoder_attention(q, k, v, H).numpy(),
        k2.encoder_attention_plain(q, k, v, H).numpy())
    assert k2.encoder_attention.launches == before


@pytest.mark.parametrize("name", sorted(kernel_variants.VARIANTS))
def test_k2_variants_still_apply(name):
    """Every timing variant of the bf16 kernel still finds the lines it
    replaces, so ops/kernel_variants.py keeps working as the kernel changes."""
    src = kernel_variants.variant_source(name)
    assert "attention_bf16_kernel" in src
    assert (src == (kernel_variants.build.CSRC / "encoder_attention.cu")
            .read_text()) == (name == "as_built")
