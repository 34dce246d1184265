"""Kernel K1's arithmetic, emulated in numpy on the CPU, against the JAX
package's log-mel; and the host layout of K1's operands (ops/logmel.py).

The emulation reads the DFT and filterbank back out of the very stages the
kernel copies (``kernel_operands``), frames the audio with the kernel's own
reflect-index arithmetic, folds each frame about its centre as the kernel
does, and runs both products as the kernel does: each operand split into
TF32 hi/lo halves (``cvt.rna.tf32.f32`` rounding), three TF32 products per
f32 product, summed in f32. Inputs are made with numpy from a
seed: noise, and voiced speech followed by silence (quiet bins near the
clamp floor)."""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from clearconverse_tpu.audio import mel as jmel

from clearconverse_tpu_torch.audio import mel as tmel
from clearconverse_tpu_torch.ops import kernel_variants
from clearconverse_tpu_torch.ops import logmel as k1

SR = 16000


def _noise(t, seed):
    return (np.random.default_rng(seed).standard_normal((1, t))
            .astype(np.float32) * 0.1)


def _speech_then_silence(t, seed):
    """Voiced, syllable-modulated harmonics for the first 40 % of the row,
    digital silence after."""
    rng = np.random.default_rng(seed)
    n = int(0.4 * t)
    tt = np.arange(n) / SR
    f0 = 110 + 40 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * tt)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum(np.sin(h * phase) / h for h in range(1, 12))
    env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3, 5) * tt)) ** 2
    sig = voiced * env + 0.02 * rng.standard_normal(n)
    out = np.zeros((1, t), np.float32)
    out[0, :n] = 0.3 * sig / np.abs(sig).max()
    return out


SIGNALS = {"noise": _noise, "speech": _speech_then_silence}


@functools.lru_cache(maxsize=3)
def _unpack(n_mels, folded=True):
    """(dft [4, bins, n_k]: cos hi, cos lo, sin hi, sin lo, folded or not;
    fb [2, bins, mel_n]: hi, lo) read back out of the kernel's stages."""
    sh = k1.tile_shape(n_mels, folded)
    stages = k1.kernel_operands(n_mels, folded).reshape(sh.stages, -1)
    n_bins = sh.chunks * sh.nc
    dft = np.zeros((4, n_bins, sh.n_k), np.float32)
    fb = np.zeros((2, n_bins, sh.mel_n), np.float32)
    tile, fb_tile = sh.nc * 8, sh.mel_n * 8
    k = 0
    for j in range(sh.chunks):
        for s in range(sh.dft_stages):
            for h in range(k1.DFT_PER):
                q = k1.DFT_PER * s + h
                for m in range(4):
                    off = (4 * h + m) * tile
                    dft[m, j * sh.nc:(j + 1) * sh.nc, 8 * q:8 * q + 8] = k1.sw32(
                        stages[k, off:off + tile].reshape(-1, 8)
                    ).reshape(sh.nc, 8)
            k += 1
        for fs in range(sh.fb_stages):
            for u in range(sh.fb_per):
                i = fs * sh.fb_per + u
                if i >= sh.nc // 8:
                    break
                for m in range(2):
                    off = (2 * u + m) * fb_tile
                    fb[m, j * sh.nc + 8 * i + k1.FB_PERM] = k1.sw32(
                        stages[k, off:off + fb_tile].reshape(-1, 8)
                    ).reshape(sh.mel_n, 8).T
            k += 1
    return dft, fb


def _frames_as_kernel(audio):
    """[B, T] → [B, T//160, 401]: padded sample p of frame f is audio index
    160 f + p - 200, reflected into [0, T) as the kernel's strip load does
    (sample 400, the mirror of sample 0, lies in the strip too)."""
    T = audio.shape[1]
    idx = (np.arange(T // k1.HOP)[:, None] * k1.HOP
           + np.arange(k1.N_FFT + 1)[None, :] - k1.N_FFT // 2)
    idx = np.where(idx < 0, -idx, idx)
    idx = np.where(idx >= T, 2 * (T - 1) - idx, idx)
    return audio[:, idx]


def _product(a, b_hi, b_lo, terms):
    """a @ b as the kernel takes it: 3 terms a_hi b_hi + a_hi b_lo + a_lo
    b_hi, or 1 term a_hi b_hi (a kernel that drops the lo halves)."""
    a_hi, a_lo = k1.split_tf32(a)
    out = a_hi @ b_hi
    if terms == 3:
        out = out + a_hi @ b_lo + a_lo @ b_hi
    return out.astype(np.float32)


def emulate_mel_power(audio, n_mels=80, terms=3, folded=True):
    """The kernel's arithmetic: fold each frame (x[n] +- x[400 - n], f32;
    the unfolded variant takes x[n] for both), 3xTF32 DFT, f32 power,
    3xTF32 mel projection."""
    dft, fb = _unpack(n_mels, folded)
    x = _frames_as_kernel(audio).astype(np.float32)
    if folded:
        n = np.arange(k1.N_FOLD)
        even = x[..., n] + x[..., k1.N_FFT - n]
        odd = x[..., n] - x[..., k1.N_FFT - n]
    else:
        even = odd = x[..., :k1.N_FFT]
    re = _product(even, dft[0].T, dft[1].T, terms)
    im = _product(odd, dft[2].T, dft[3].T, terms)
    power = re * re + im * im
    return _product(power, fb[0], fb[1], terms)[..., :n_mels]


def _log_mel(power):
    import torch
    return tmel.log_mel_from_power(torch.from_numpy(power)).numpy()


def _max_err(audio, n_mels, terms, folded=True):
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(audio), n_mels))
    ours = _log_mel(emulate_mel_power(audio, n_mels, terms, folded))
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max())


@pytest.mark.parametrize("t", [16000, 33600, 480000])
@pytest.mark.parametrize("signal", sorted(SIGNALS))
def test_3xtf32_matches_jax_log_mel(signal, t):
    """3xTF32 in both products holds the JAX log-mel (HIGHEST precision) to
    atol 5e-4, the tolerance chip_smoke.py holds the kernel to."""
    assert _max_err(SIGNALS[signal](t, 3), 80, 3) <= 5e-4


@pytest.mark.parametrize("signal", sorted(SIGNALS))
def test_1xtf32_would_be_caught(signal):
    """One TF32 product per f32 product (no lo halves) misses 5e-4 on a
    30 s row, so the tolerance catches a kernel that drops them."""
    assert _max_err(SIGNALS[signal](480000, 3), 80, 1) > 5e-4


def test_3xtf32_matches_jax_log_mel_128_mels():
    """The 128-mel instance (48-bin chunks, m64n128 mel product)."""
    assert _max_err(_speech_then_silence(33600, 4), 128, 3) <= 5e-4


@pytest.mark.parametrize("signal", sorted(SIGNALS))
def test_unfolded_layout_matches_jax_log_mel(signal):
    """The operands of the unfolded timing variant (the full 400-sample
    DFT, ops/kernel_variants.py) hold the JAX log-mel as well."""
    assert _max_err(SIGNALS[signal](33600, 6), 80, 3, folded=False) <= 5e-4


@pytest.mark.parametrize("t", [16000, 480000])
def test_fold_matches_full_dft(t):
    """Folding about the frame's centre loses nothing: the folded f32 DFT
    gives the full one's power to f32 rounding."""
    from clearconverse_tpu_torch.audio.mel import _dft_matrices
    x = _frames_as_kernel(_noise(t, 5)).astype(np.float64)
    cos_m, sin_m = _dft_matrices()
    cos_f, sin_f = k1.folded_dft()
    n = np.arange(k1.N_FOLD)
    full = (x[..., :400] @ cos_m) ** 2 + (x[..., :400] @ sin_m) ** 2
    fold = (((x[..., n] + x[..., 400 - n]) @ cos_f) ** 2
            + ((x[..., n] - x[..., 400 - n]) @ sin_f) ** 2)
    np.testing.assert_allclose(fold, full, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_hi_lo_reconstruct_operands(n_mels):
    """hi + lo gives each folded DFT and filterbank value to 2^-22
    relative."""
    dft, fb = _unpack(n_mels)
    cos_f, sin_f = k1.folded_dft()
    fbank = tmel.mel_filterbank(n_mels=n_mels)
    n = k1.N_FREQ
    for hi, lo, want in ((dft[0, :n], dft[1, :n], cos_f.T),
                         (dft[2, :n], dft[3, :n], sin_f.T),
                         (fb[0, :n, :n_mels], fb[1, :n, :n_mels], fbank)):
        got = hi.astype(np.float64) + lo
        assert np.all(np.abs(got - want) <= 2.0 ** -22 * np.abs(want))
        assert np.all(np.abs(lo) <= 2.0 ** -11 * np.abs(want))


@pytest.mark.parametrize("folded", [True, False])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_operands_are_exact_tf32(n_mels, folded):
    """Every word of every stage has its low 13 bits zero, so the tensor
    cores read it exactly; the buffer is as long as its shape says (the
    kernel refuses a buffer of another size)."""
    words = k1.kernel_operands(n_mels, folded).view(np.uint32)
    sh = k1.tile_shape(n_mels, folded)
    assert words.size == sh.stages * sh.stage_bytes // 4
    assert not np.any(words & 0x1FFF)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_padded_bins_and_mels_are_zero(n_mels):
    """Bins past 200, folded samples 0 and past 200, and mels past n_mels
    carry zero weight."""
    dft, fb = _unpack(n_mels)
    assert not dft[:, k1.N_FREQ:].any()
    assert not dft[:, :, 0].any() and not dft[:, :, 201:].any()
    assert not fb[:, k1.N_FREQ:].any()
    assert not fb[:, :, n_mels:].any()
    assert dft[0, :k1.N_FREQ].any() and fb[0, :k1.N_FREQ].any()


@pytest.mark.parametrize("n_mels", [80, 128])
def test_filterbank_permutation(n_mels):
    """Read straight from the stream: in each filterbank k8 tile, k-slot t
    holds bin 8g + 2t and slot t + 4 holds bin 8g + 2t + 1."""
    sh = k1.tile_shape(n_mels)
    stages = k1.kernel_operands(n_mels).reshape(sh.stages, -1)
    fb_hi = k1.split_tf32(tmel.mel_filterbank(n_mels=n_mels))[0]
    fb_tile = sh.mel_n * 8
    seen = 0
    for j in range(sh.chunks):
        for i in range(sh.nc // 8):
            fs, u = divmod(i, sh.fb_per)
            k = j * (sh.dft_stages + sh.fb_stages) + sh.dft_stages + fs
            tile = k1.sw32(stages[k, 2 * u * fb_tile:(2 * u + 1) * fb_tile]
                           .reshape(-1, 8)).reshape(sh.mel_n, 8)
            g = j * sh.nc + 8 * i
            for t in range(4):
                for slot, b in ((t, g + 2 * t), (t + 4, g + 2 * t + 1)):
                    want = fb_hi[b] if b < k1.N_FREQ else 0.0
                    np.testing.assert_array_equal(tile[:n_mels, slot], want)
            seen += 1
    assert seen * 8 >= k1.N_FREQ


def test_sw32_swaps_halves_of_rows_4_to_7():
    tile = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    img = k1.sw32(tile).reshape(16, 8)
    for r in range(16):
        want = tile[r] if (r >> 2) & 1 == 0 else np.r_[tile[r, 4:], tile[r, :4]]
        np.testing.assert_array_equal(img[r], want)
    np.testing.assert_array_equal(k1.sw32(img).reshape(16, 8), tile)


def test_tf32_round_is_rna():
    """Round to nearest with ties away from zero, at 10 mantissa bits."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                  1 + 3 * 2.0 ** -11], np.float32)
    np.testing.assert_array_equal(
        k1.tf32_round(x),
        np.array([one + ulp, -(one + ulp), one, one + 2 * ulp], np.float32))


@pytest.mark.parametrize("name", sorted(kernel_variants.K1_VARIANTS))
def test_k1_variants_still_apply(name):
    """Every timing variant of K1 still finds the lines it replaces, so
    ops/kernel_variants.py keeps working as the kernel changes."""
    src = kernel_variants.variant_source(name, "k1")
    assert "mel_power_kernel" in src
    assert (src == (kernel_variants.build.CSRC / "logmel.cu").read_text()) == (
        name == "as_built")
