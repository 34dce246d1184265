"""The port's audio path against the JAX package's on the same inputs (numpy
seeds), with the reference tests' tolerances (tests/test_audio.py), TF32
pinned off: resample, the spectral gate and the three wire gates, the
lossless packed wire (bit-exact), the mu-law codec, the native packer, and
load_audio_many on a 16 kHz int16 WAV and a 44.1 kHz float WAV."""

import struct

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from clearconverse_tpu.audio import decode as jdecode
from clearconverse_tpu.audio import denoise as jden
from clearconverse_tpu.audio import pack as jpack
from clearconverse_tpu.audio import wire as jwire
from clearconverse_tpu.audio.resample import resample as jresample

from clearconverse_tpu_torch.audio import decode as tdecode
from clearconverse_tpu_torch.audio import denoise as tden
from clearconverse_tpu_torch.audio import native
from clearconverse_tpu_torch.audio import pack as tpack
from clearconverse_tpu_torch.audio import wav as twav
from clearconverse_tpu_torch.audio import wire as twire
from clearconverse_tpu_torch.audio.resample import resample as tresample

# The suite runs several pytest workers on one host; with torch's default of
# one intra-op thread per core they oversubscribe it, and these small ops
# then run ~100x slower than alone. One thread each keeps them fast.
torch.set_num_threads(1)

SR = 16000


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _speechlike(rng, n, f=220.0, noise=0.01):
    t = np.arange(n) / SR
    return (0.4 * np.sin(2 * np.pi * f * t)
            + rng.standard_normal(n) * noise).astype(np.float32)


@pytest.mark.parametrize("orig,new", [(44100, 16000), (8000, 16000),
                                      (22050, 16000)])
def test_resample_matches_jax(orig, new, rng):
    x = rng.standard_normal((2, orig // 4)).astype(np.float32)
    ours = tresample(torch.from_numpy(x), orig, new).numpy()
    ref = np.asarray(jresample(jnp.asarray(x), orig, new))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=2e-4)


@pytest.mark.parametrize("prop", [0.2, 0.5, 1.0])
def test_spectral_gate_matches_jax(prop, rng):
    """Masked batch gate (one row padded) within the reference's host-vs-
    device tolerance, 2e-5."""
    x = np.stack([_speechlike(rng, 20000), _speechlike(rng, 20000, 330.0)])
    x[:, 12000:14000] += rng.standard_normal(2000).astype(np.float32) * 0.3
    mask = np.ones_like(x)
    mask[1, 15000:] = 0.0
    x[1, 15000:] = 0.0
    ours = tden.spectral_gate(torch.from_numpy(x), SR, prop,
                              torch.from_numpy(mask)).numpy()
    ref = np.asarray(jden.spectral_gate(jnp.asarray(x), SR, prop,
                                        jnp.asarray(mask)))
    np.testing.assert_allclose(ours, ref, atol=2e-5)
    one = tden.spectral_gate(torch.from_numpy(x[0]), SR, prop).numpy()
    np.testing.assert_allclose(
        one, np.asarray(jden.spectral_gate(jnp.asarray(x[0]), SR, prop)),
        atol=2e-5)


def _i16_batch(rng):
    t = np.arange(SR) / SR
    q = np.zeros((2, SR), np.int16)
    q[0] = np.round(9000 * np.sin(2 * np.pi * 300 * t)
                    + rng.standard_normal(SR) * 150).astype(np.int16)
    # A loud tone with noise (a pure tone's leakage bins sit within rounding
    # of the gate's threshold), cut at a peak so the packer tapers the pad.
    tone = np.round(25000 * np.sin(2 * np.pi * 150 * t)
                    + rng.standard_normal(SR) * 150).astype(np.int16)
    n1 = int(np.argmax(tone[10500:12000])) + 10500 + 1
    q[1, :n1] = tone[:n1]
    return q, np.array([SR, n1], np.int32)


@pytest.mark.parametrize("denoise", [True, False])
def test_gate_normalize_i16_matches_jax(denoise, rng):
    q, n_valid = _i16_batch(rng)
    y, qo = tden.gate_normalize_i16(torch.from_numpy(q), 0.5,
                                    torch.from_numpy(n_valid), sr=SR,
                                    denoise=denoise)
    yr, qr = jden.gate_normalize_i16_jit(jnp.asarray(q), 0.5,
                                         jnp.asarray(n_valid), sr=SR,
                                         denoise=denoise)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=2e-5)
    assert qo.dtype == torch.int16
    assert np.max(np.abs(qo.numpy().astype(np.int32)
                         - np.asarray(qr).astype(np.int32))) <= 1


@pytest.mark.parametrize("denoise", [True, False])
def test_gate_normalize_packed_bit_equals_i16_and_matches_jax(denoise, rng):
    """The packed wire's gate is bit-identical to the int16 wire's on the
    batch that was packed (the taper never reaches the gate), and within
    2e-5 of the JAX packed gate."""
    q, n_valid = _i16_batch(rng)
    pb = tpack.pack_i16_batch(q.copy(), n_valid)
    assert pb is not None
    args = [torch.from_numpy(a) for a in (pb.data, pb.x0, pb.e1)]
    y, qo = tden.gate_normalize_packed(*args, pb.order == 2, 0.5,
                                       torch.from_numpy(n_valid), sr=SR,
                                       denoise=denoise, width=pb.width)
    y16, q16 = tden.gate_normalize_i16(torch.from_numpy(q), 0.5,
                                       torch.from_numpy(n_valid), sr=SR,
                                       denoise=denoise)
    assert torch.equal(y, y16) and torch.equal(qo, q16)
    yr, _ = jden.gate_normalize_packed_jit(
        jnp.asarray(pb.data), jnp.asarray(pb.x0), jnp.asarray(pb.e1),
        pb.order == 2, 0.5, jnp.asarray(n_valid), sr=SR, denoise=denoise,
        width=pb.width)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=2e-5)


def test_gate_normalize_u8_matches_jax(rng):
    x = np.stack([_speechlike(rng, SR), _speechlike(rng, SR, 500.0)])
    x[1, 12000:] = 0.0
    codes = jwire.mulaw_encode_np(x / np.abs(x).max(axis=1, keepdims=True))
    n_valid = np.array([SR, 12000], np.int32)
    y, qo = tden.gate_normalize_u8(torch.from_numpy(codes), 0.5,
                                   torch.from_numpy(n_valid), sr=SR)
    yr, qr = jden.gate_normalize_u8_jit(jnp.asarray(codes), 0.5,
                                        jnp.asarray(n_valid), sr=SR)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=2e-5)
    assert np.max(np.abs(qo.numpy().astype(np.int32)
                         - np.asarray(qr).astype(np.int32))) <= 1


def test_spectral_gate_normalized_matches_jax(rng):
    x = np.stack([_speechlike(rng, 12000), _speechlike(rng, 12000, 90.0)])
    n = np.array([12000, 7000], np.int32)
    x[1, 7000:] = 0.0
    ours = tden.spectral_gate_normalized(torch.from_numpy(x), 0.3,
                                         torch.from_numpy(n), sr=SR).numpy()
    ref = np.asarray(jden.spectral_gate_normalized_jit(
        jnp.asarray(x), 0.3, jnp.asarray(n), sr=SR))
    np.testing.assert_allclose(ours, ref, atol=2e-5)
    np.testing.assert_allclose(
        tden.peak_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jden.peak_normalize(jnp.asarray(x))), atol=1e-7)


@pytest.mark.parametrize("width", [8, 10, 12, 13, 15])
@pytest.mark.parametrize("order", [1, 2])
def test_device_unpack_bit_exact_against_jax(width, order, rng):
    """pack → the port's device unpack equals unpack_delta_jnp bit for bit
    and rebuilds the valid region of the int16 batch exactly."""
    T = 4096
    lim = (1 << (width - 1)) - 1
    if order == 1:
        d = rng.integers(-lim, lim + 1, size=(3, T))
    else:
        d = np.cumsum(rng.integers(-lim // 4, lim // 4 + 1, size=(3, T)), 1)
        d = np.clip(d, -lim, lim)
    x = np.clip(np.cumsum(d, axis=1), -32768, 32767).astype(np.int16)
    u = np.zeros((3, T), np.int32)
    x32 = x.astype(np.int32)
    d1 = np.diff(x32, axis=1)
    p = d1[:, 1:] if order == 1 else np.diff(d1, axis=1)
    if np.abs(p).max() > lim:
        pytest.skip("clipped walk left the width")
    u[:, 2:] = p + (1 << (width - 1))
    u[:, :2] = 1 << (width - 1)
    data = tpack.pack_bits_np(u.astype(np.uint16), width)
    x0, e1 = x32[:, 0].copy(), d1[:, 0].copy()
    ours = tpack.unpack_delta(torch.from_numpy(data), torch.from_numpy(x0),
                              torch.from_numpy(e1), order == 2, width)
    ref = np.asarray(jpack.unpack_delta_jnp(jnp.asarray(data),
                                            jnp.asarray(x0), jnp.asarray(e1),
                                            order == 2, width))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(ours.numpy(), x32)


def test_native_packer_matches_jax_and_numpy_oracle(rng):
    """The port's own wavcodec build packs the same bytes as the JAX
    package's native packer and as the numpy oracle."""
    assert native.get_lib() is not None
    q, n_valid = _i16_batch(rng)
    ours = tpack.pack_i16_batch(q.copy(), n_valid)
    ref = jpack.pack_i16_batch(q.copy(), n_valid)
    assert (ours.order, ours.width, ours.t) == (ref.order, ref.width, ref.t)
    for a, b in ((ours.data, ref.data), (ours.x0, ref.x0), (ours.e1, ref.e1)):
        np.testing.assert_array_equal(a, b)
    assert native.lib_path().endswith(".so") and "_build" in native.lib_path()


def test_pack_without_native_falls_back_unless_numpy(rng, monkeypatch):
    q, n_valid = _i16_batch(rng)
    want = tpack.pack_i16_batch(q.copy(), n_valid)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert tpack.pack_i16_batch(q.copy(), n_valid) is None
    got = tpack.pack_i16_batch(q.copy(), n_valid, allow_numpy=True)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(tpack.unpack_bits_np(got.data, got.width),
                                  jpack.unpack_bits_np(want.data, want.width))


def test_mulaw_codes_identical_to_jax(rng):
    x = np.concatenate([np.clip(rng.standard_normal(4000) * 0.3, -1, 1),
                        [0.0, 1.0, -1.0, 1e-6, -1e-6]]).astype(np.float32)
    np.testing.assert_array_equal(twire.mulaw_encode_np(x),
                                  jwire.mulaw_encode_np(x))
    ours = twire.mulaw_encode(torch.from_numpy(x[None])).numpy()
    ref = np.asarray(jwire.mulaw_encode_jnp(jnp.asarray(x[None])))
    np.testing.assert_array_equal(ours, ref)
    w = np.round(x * 20000).astype(np.int16)
    np.testing.assert_array_equal(twire.mulaw_encode_i16_np(w),
                                  jwire.mulaw_encode_i16_np(w))
    codes = np.arange(256, dtype=np.uint8)[None]
    np.testing.assert_allclose(twire.mulaw_expand(torch.from_numpy(codes)).numpy(),
                               np.asarray(jwire.mulaw_expand_jnp(
                                   jnp.asarray(codes))), atol=1e-6)
    np.testing.assert_allclose(twire.mulaw_decode_np(codes),
                               jwire.mulaw_decode_np(codes), atol=0)
    assert twire.mulaw_expand(torch.tensor([[128]], dtype=torch.uint8)).item() == 0.0


def _write_float_wav(path, x, rate):
    """IEEE-float 32-bit stereo WAV (format tag 3)."""
    body = np.ascontiguousarray(x.T).astype("<f4").tobytes()
    ch = x.shape[0]
    hdr = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 3, ch, rate, rate * ch * 4,
                                 ch * 4, 32)
    hdr += b"data" + struct.pack("<I", len(body))
    with open(path, "wb") as fh:
        fh.write(hdr + body)


@pytest.fixture
def two_wavs(tmp_path, rng):
    p16 = str(tmp_path / "int16.wav")
    twav.write_wav(p16, _speechlike(rng, 40000), SR)
    p44 = str(tmp_path / "float44k.wav")
    t = np.arange(44100) / 44100
    st = np.stack([0.3 * np.sin(2 * np.pi * 180 * t),
                   0.2 * np.sin(2 * np.pi * 260 * t)]).astype(np.float32)
    _write_float_wav(p44, st, 44100)
    bad = str(tmp_path / "broken.wav")
    with open(bad, "wb") as fh:
        fh.write(b"not a wav")
    return [p16, bad, p44]


@pytest.mark.parametrize("wire_bits", [0, 16, 8])
def test_load_audio_many_matches_jax(two_wavs, wire_bits):
    """Rows, row_map and wire_info equal the JAX package's; gated rows agree
    within the reference's 1e-4, the device batch too."""
    kw = dict(noise_reduction_amount=0.4, return_device=True,
              wire_bits=wire_bits)
    info_t, info_j = {}, {}
    h_t, b_t, m_t = tdecode.load_audio_many(two_wavs, wire_info=info_t,
                                            device="cpu", **kw)
    h_j, b_j, m_j = jdecode.load_audio_many(two_wavs, wire_info=info_j, **kw)
    assert m_t == m_j == [0, None, 1]
    assert h_t[1] is None and h_j[1] is None
    assert info_t == info_j
    assert tuple(b_t.shape) == tuple(b_j.shape)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-4)
    for a, b in zip(h_t, h_j):
        if a is not None:
            assert len(a) == len(b)
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)
    if wire_bits == 0:
        assert info_t["format"] == "packed_delta"


def test_load_audio_many_async_is_lazy_and_equal(two_wavs):
    stats = {}
    h, b, m = tdecode.load_audio_many(two_wavs, noise_reduction_amount=0.4,
                                      return_device=True, host_async=True,
                                      stage_times=stats, wire_bits=0,
                                      device="cpu")
    sync = tdecode.load_audio_many(two_wavs, noise_reduction_amount=0.4,
                                   wire_bits=0, device="cpu")
    assert isinstance(h[0], tdecode.LazyAudio) and len(h[0]) == len(sync[0])
    assert "download_async" not in stats           # nothing read yet
    clip = tdecode.lazy_slice(h[2], 100, 900)
    assert isinstance(clip, tdecode.LazyClip) and len(clip) == 800
    np.testing.assert_array_equal(np.asarray(clip), sync[2][100:900])
    np.testing.assert_array_equal(np.asarray(h[0]), sync[0])
    h[0].wait()
    h[0].stats_flush()
    assert "download_async" in stats


def test_load_audio_matches_jax(two_wavs):
    for p in (two_wavs[0], two_wavs[2]):
        ours, sr = tdecode.load_audio(p, 16000, 0.5, device="cpu")
        ref, sr_j = jdecode.load_audio(p, 16000, 0.5)
        assert sr == sr_j and ours.shape[0] == np.asarray(ref).shape[0]
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def test_read_wav_i16_and_scanned_reuse(two_wavs):
    from clearconverse_tpu.audio.wav import read_wav_i16 as j_read_i16
    scanned = twav._scan_chunks(two_wavs[0])
    q, rate = twav.read_wav_i16(two_wavs[0], scanned=scanned)
    qj, rate_j = j_read_i16(two_wavs[0])
    assert rate == rate_j == SR and q.dtype == np.int16
    np.testing.assert_array_equal(q, qj)
    assert twav.read_wav_i16(two_wavs[2]) is None     # float stereo: no
    a, _ = twav.read_wav(two_wavs[2], scanned=twav._scan_chunks(two_wavs[2]))
    np.testing.assert_array_equal(a, twav.read_wav(two_wavs[2])[0])


def test_load_audio_many_rejects_unknown_wire(two_wavs):
    with pytest.raises(ValueError, match="wire_bits"):
        tdecode.load_audio_many(two_wavs, wire_bits=4, device="cpu")
