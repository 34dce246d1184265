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


def _write_wav_with_chunks(path, q, rate):
    """Mono int16 WAV whose fmt chunk is WAVE_FORMAT_EXTENSIBLE (SubFormat
    PCM), led by an odd-sized LIST chunk and with an odd-sized chunk
    between fmt and data, each padded to a word."""
    ext = struct.pack("<HHIIHHHHIH14x", 0xFFFE, 1, rate, rate * 2, 2, 16, 22,
                      16, 4, 1)
    body = q.astype("<i2").tobytes()
    chunks = (b"LIST" + struct.pack("<I", 5) + b"INFOx\0"
              + b"fmt " + struct.pack("<I", len(ext)) + ext
              + b"junk" + struct.pack("<I", 3) + b"abc\0"
              + b"data" + struct.pack("<I", len(body)) + body)
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE"
                 + chunks)


@pytest.fixture
def wav_mix(tmp_path, rng):
    """16 kHz int16 mono files of two length buckets (1 s and 5 s), a
    44.1 kHz float stereo file, a broken file and a 16 kHz int16 WAV with
    an extension chunk and odd-sized chunks."""
    paths = []
    for k, n in enumerate((12800, 70000, 9000)):
        p = str(tmp_path / f"int16_{k}.wav")
        twav.write_wav(p, _speechlike(rng, n, 200.0 + 40 * k), SR)
        paths.append(p)
    p44 = str(tmp_path / "float44k.wav")
    t = np.arange(30000) / 44100
    _write_float_wav(p44, np.stack([0.3 * np.sin(2 * np.pi * 180 * t),
                                    0.2 * np.sin(2 * np.pi * 260 * t)])
                     .astype(np.float32), 44100)
    bad = str(tmp_path / "broken.wav")
    with open(bad, "wb") as fh:
        fh.write(b"RIFF\0\0\0\0WAVEnot a chunk")
    pext = str(tmp_path / "extensible.wav")
    _write_wav_with_chunks(pext, np.round(_speechlike(rng, 20001) * 30000)
                           .astype(np.int16), SR)
    return [paths[0], p44, bad, paths[1], pext, paths[2]]


def _sequential_build(paths):
    """The batch as a loop over the files builds it: each file read whole
    and parsed, int16 rows copied, float rows scaled to their peak, into
    one fresh zeroed [K, T] → (batch, path index of each row, n_valid)."""
    waves, order = [], []
    for i, p in enumerate(paths):
        try:
            scanned = twav._scan_chunks(p)
            fast = twav.read_wav_i16(p, scanned=scanned)
            if fast is not None and fast[1] == SR:
                waves.append(fast[0])
            else:
                x, sr = twav.read_wav(p, scanned=scanned)
                mono = x.mean(axis=0).astype(np.float32)
                n = len(mono)
                pad = np.pad(mono, (0, tdecode._next_bucket(n, sr) - n))
                waves.append(tresample(torch.from_numpy(pad), sr, SR)
                             [: int(np.ceil(SR * n / sr))].numpy())
            order.append(i)
        except ValueError:
            pass
    n_outs = [len(w) for w in waves]
    q = np.zeros((len(waves), tdecode._next_bucket(max(n_outs), SR)),
                 np.int16)
    for row, w in enumerate(waves):
        if w.dtype == np.int16:
            q[row, : len(w)] = w
        else:
            peak = max(float(np.max(np.abs(w))), 1e-12)
            q[row, : len(w)] = np.clip(np.round(w * (32767.0 / peak)),
                                       -32768, 32767).astype(np.int16)
    return q, order, np.array(n_outs, np.int32)


def _staged(paths, pinned=False):
    direct, converted = tdecode._scan_files(paths, SR, torch.device("cpu"))
    with tdecode._STAGING.lock:
        st = tdecode._stage(direct, converted, SR, pinned)
        return st, st.rows.numpy().copy()


def test_staged_batch_equals_the_sequential_build(wav_mix):
    """The parallel reader's batch equals the sequential build byte for
    byte, and load_audio_many's rows, row map and gated rows are those of
    the sequential batch through the int16 gate, bit for bit."""
    want, order, n_valid = _sequential_build(wav_mix)
    assert order == [0, 1, 3, 4, 5] and want.shape == (5, 5 * SR)
    st, got = _staged(wav_mix)
    assert st.order == order and st.n_outs == list(n_valid)
    assert got.tobytes() == want.tobytes()
    y, qo = tden.gate_normalize_i16(torch.from_numpy(want), 0.4,
                                    torch.from_numpy(n_valid), sr=SR)
    _, _, m_j = jdecode.load_audio_many(wav_mix, noise_reduction_amount=0.4,
                                        return_device=True)
    for wire_bits in (16, 0):
        h, b, m = tdecode.load_audio_many(
            wav_mix, noise_reduction_amount=0.4, return_device=True,
            wire_bits=wire_bits, device="cpu")
        assert m == m_j == [0, 1, None, 2, 3, 4]
        assert torch.equal(b, y)
        host = qo.numpy().astype(np.float32) / 32767.0
        for row, i in enumerate(order):
            np.testing.assert_array_equal(h[i], host[row, : n_valid[row]])
        assert h[2] is None


def test_staging_is_reused_and_zeroed_past_each_row(monkeypatch, tmp_path,
                                                    rng):
    """Two calls in a row, the second with fewer and shorter rows: the
    second reuses the buffer, and no sample of the first survives past any
    row's n_valid; a batch larger than the buffer allocates anew."""
    monkeypatch.setattr(tdecode, "_STAGING", tdecode._Staging())
    paths = []
    for k, n in enumerate((70000, 66000, 71000, 9000, 12000)):
        p = str(tmp_path / f"f{k}.wav")
        twav.write_wav(p, _speechlike(rng, n, 150.0 + 50 * k, noise=0.2), SR)
        paths.append(p)
    seen = []
    for batch in (paths[:3], paths[3:], paths):
        info = {}
        tdecode.load_audio_many(batch, noise_reduction_amount=0.4,
                                wire_bits=16, device="cpu",
                                staging_info=info)
        seen.append(info["staging_reused"])
        if batch == paths[3:]:
            st, q = _staged(batch)
            assert st.reused and q.shape == (2, SR)
            for row, p in enumerate(batch):
                x, _ = twav.read_wav_i16(p)
                np.testing.assert_array_equal(q[row, : len(x)], x)
                assert not q[row, len(x):].any()
    assert seen == [0, 1, 0]


@pytest.mark.parametrize("wire_bits", [0, 16, 8])
def test_staging_counts_every_loaded_row(wav_mix, wire_bits):
    """rows_direct + rows_converted is the number of files that loaded; the
    staging counters leave wire_info as the JAX package writes it."""
    info, wire = {}, {}
    h = tdecode.load_audio_many(wav_mix, wire_bits=wire_bits, device="cpu",
                                staging_info=info, wire_info=wire)
    wire_j = {}
    jdecode.load_audio_many(wav_mix, wire_bits=wire_bits, wire_info=wire_j)
    assert wire == wire_j
    assert info["rows_direct"] == 4 and info["rows_converted"] == 1
    assert info["rows_direct"] + info["rows_converted"] == sum(
        x is not None for x in h)


def test_odd_int16_payload_fails_as_in_jax(tmp_path, rng):
    """A mono int16 file whose data chunk has an odd size fails to load in
    both packages, at the target rate and at another."""
    good = str(tmp_path / "good.wav")
    twav.write_wav(good, _speechlike(rng, 8000), SR)
    paths = [good]
    for rate in (SR, 8000):
        p = str(tmp_path / f"odd{rate}.wav")
        body = (np.round(_speechlike(rng, 4000) * 3e4).astype("<i2")
                .tobytes() + b"\1")
        hdr = b"RIFF" + struct.pack("<I", 36 + len(body) + 1) + b"WAVE"
        hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2,
                                     2, 16)
        with open(p, "wb") as fh:
            fh.write(hdr + b"data" + struct.pack("<I", len(body)) + body
                     + b"\0")
        paths.append(p)
    _, _, m_t = tdecode.load_audio_many(paths, return_device=True,
                                        device="cpu")
    _, _, m_j = jdecode.load_audio_many(paths, return_device=True)
    assert m_t == m_j == [0, None, None]


def test_a_row_that_cannot_be_read_drops_its_file(wav_mix):
    """A file cut short after its header was read is dropped when its row
    is read, and the batch is laid out again without it: rows, n_valid and
    bucket as if the file had never loaded."""
    direct, converted = tdecode._scan_files(wav_mix, SR, torch.device("cpu"))
    with open(wav_mix[3], "r+b") as fh:      # the only 5 s file
        fh.truncate(1000)
    with tdecode._STAGING.lock:
        st = tdecode._stage(direct, converted, SR, False)
        got = st.rows.numpy().copy()
    assert st.order == [0, 1, 4, 5] and got.shape == (4, 2 * SR)
    want, order, _ = _sequential_build([p for i, p in enumerate(wav_mix)
                                        if i != 3])
    assert got.tobytes() == want.tobytes()


def test_concurrent_loads_share_the_staging_batch(tmp_path, rng):
    """More callers than cores through one staging buffer, with thread
    switches forced often: every caller gets its own files' rows."""
    import sys
    import threading

    paths = []
    for k in range(12):
        p = str(tmp_path / f"c{k}.wav")
        twav.write_wav(p, _speechlike(rng, 4000 + 700 * k, 120.0 + 30 * k,
                                      noise=0.1), SR)
        paths.append(p)
    sets = [paths[k: k + 3] for k in range(10)]
    want = [tdecode.load_audio_many(s, denoise=False, device="cpu")
            for s in sets]
    done, errors = [0] * len(sets), []

    def run(k):
        try:
            for _ in range(3):
                got = tdecode.load_audio_many(sets[k], denoise=False,
                                              device="cpu")
                for a, b in zip(got, want[k]):
                    np.testing.assert_array_equal(a, b)
                done[k] += 1
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,))
                   for k in range(len(sets))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors and done == [3] * len(sets)
