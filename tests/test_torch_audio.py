"""The port's audio path against the JAX package's on the same inputs (numpy
seeds), with the reference tests' tolerances (tests/test_audio.py), TF32
pinned off: resample, the spectral gate, the int16 gate, and load_audio_many
on 16 kHz int16 WAVs and 44.1 kHz float WAVs against the JAX package's int16
wire, with rows at the edges of a length bucket."""

import struct

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from clearconverse_tpu.audio import decode as jdecode
from clearconverse_tpu.audio import denoise as jden
from clearconverse_tpu.audio.resample import resample as jresample

from clearconverse_tpu_torch.audio import decode as tdecode
from clearconverse_tpu_torch.audio import denoise as tden
from clearconverse_tpu_torch.audio import wav as twav
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
    # of the gate's threshold), cut at a peak, so the row ends on a step.
    tone = np.round(25000 * np.sin(2 * np.pi * 150 * t)
                    + rng.standard_normal(SR) * 150).astype(np.int16)
    n1 = int(np.argmax(tone[10500:12000])) + 10500 + 1
    q[1, :n1] = tone[:n1]
    return q, np.array([SR, n1], np.int32)


@pytest.mark.parametrize("prop", [0.2, 0.5, 1.0])
@pytest.mark.parametrize("denoise", [True, False])
def test_gate_normalize_i16_matches_jax(denoise, prop, rng):
    q, n_valid = _i16_batch(rng)
    y, qo = tden.gate_normalize_i16(torch.from_numpy(q), prop,
                                    torch.from_numpy(n_valid), sr=SR,
                                    denoise=denoise)
    yr, qr = jden.gate_normalize_i16_jit(jnp.asarray(q), prop,
                                         jnp.asarray(n_valid), sr=SR,
                                         denoise=denoise)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=2e-5)
    assert qo.dtype == torch.int16
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


@pytest.mark.parametrize("return_device", [True, False])
@pytest.mark.parametrize("amount", [0.0, 0.4])
def test_load_audio_many_matches_jax(two_wavs, amount, return_device):
    """Rows, row_map and wire_info equal the JAX package's int16 wire; gated
    rows agree within the reference's 1e-4, the device batch too. Amount 0
    without the device batch is the dev backend's load."""
    kw = dict(noise_reduction_amount=amount, return_device=return_device)
    info_t, info_j = {}, {}
    out_t = tdecode.load_audio_many(two_wavs, wire_info=info_t,
                                    device="cpu", **kw)
    out_j = jdecode.load_audio_many(two_wavs, wire_info=info_j,
                                    wire_bits=16, **kw)
    if return_device:
        (h_t, b_t, m_t), (h_j, b_j, m_j) = out_t, out_j
        assert m_t == m_j == [0, None, 1]
        assert tuple(b_t.shape) == tuple(b_j.shape)
        np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-4)
    else:
        h_t, h_j = out_t, out_j
    assert h_t[1] is None and h_j[1] is None
    assert info_t == info_j and info_t["format"] == "int16"
    for a, b in zip(h_t, h_j):
        if a is not None:
            assert isinstance(a, np.ndarray) and len(a) == len(b)
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)


def test_load_audio_many_async_is_lazy_and_equal(two_wavs):
    stats = {}
    h, b, m = tdecode.load_audio_many(two_wavs, noise_reduction_amount=0.4,
                                      return_device=True, host_async=True,
                                      stage_times=stats, device="cpu")
    sync = tdecode.load_audio_many(two_wavs, noise_reduction_amount=0.4,
                                   device="cpu")
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


def test_read_wav_i16_bit_equals_jax(two_wavs):
    from clearconverse_tpu.audio.wav import read_wav_i16 as j_read_i16
    q, rate = twav.read_wav_i16(two_wavs[0])
    qj, rate_j = j_read_i16(two_wavs[0])
    assert rate == rate_j == SR and q.dtype == np.int16
    np.testing.assert_array_equal(q, qj)
    assert twav.read_wav_i16(two_wavs[2]) is None     # float stereo: no


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
            fast = twav.read_wav_i16(p)
            if fast is not None and fast[1] == SR:
                waves.append(fast[0])
            else:
                x, sr = twav.read_wav(p)
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
    h, b, m = tdecode.load_audio_many(
        wav_mix, noise_reduction_amount=0.4, return_device=True,
        device="cpu")
    assert m == m_j == [0, 1, None, 2, 3, 4]
    assert torch.equal(b, y)
    host = qo.numpy().astype(np.float32) / 32767.0
    for row, i in enumerate(order):
        np.testing.assert_array_equal(h[i], host[row, : n_valid[row]])
    assert h[2] is None


# Rows at the edges of a length bucket, as (kind, samples in the file) per
# file: "i16" a 16 kHz int16 mono WAV read as it is; converted on load, "f44"
# a 44.1 kHz float stereo WAV, "i8k" and "i48k" int16 mono WAVs at 8 and
# 48 kHz (16002 and 16000 samples at 16 kHz), "s16" a 16 kHz int16 stereo WAV.
_EDGE_ROWS = {
    "odd_short": [("i16", 401)],
    "bucket_minus_1": [("i16", SR - 1)],
    "bucket_exact": [("i16", SR)],
    "bucket_plus_1": [("i16", SR + 1)],
    "converted": [("f44", 30001)],
    "converted_8k_int16": [("i8k", 8001)],
    "converted_48k_int16": [("i48k", 47999)],
    "converted_stereo_int16": [("s16", SR)],
    "mixed": [("i16", 401), ("i16", 2 * SR), ("f44", 30001), ("i16", SR + 1)],
    "mixed_converted": [("i8k", 8001), ("s16", 401), ("i16", SR - 1),
                        ("i48k", 47999)],
}
_EDGE_RATES = {"i16": SR, "i8k": 8000, "i48k": 48000, "s16": SR}


@pytest.mark.parametrize("case", sorted(_EDGE_ROWS))
def test_rows_at_bucket_edges_reach_the_gate_unchanged(case, tmp_path, rng):
    """The int16 batch reaches the gate as the sequential build makes it at
    the edges of a row: load_audio_many's gated batch and int16 download
    equal gate_normalize_i16 of the sequentially built rows bit for bit,
    are zero past each row's end, and are within 1e-4 of the JAX package's
    int16 wire."""
    paths = []
    for k, (kind, n) in enumerate(_EDGE_ROWS[case]):
        p = str(tmp_path / f"{k}_{kind}.wav")
        if kind == "s16":
            x = np.stack([_speechlike(rng, n, f, noise=0.05)
                          for f in (170.0, 290.0)])
            twav.write_wav(p, x, SR)
        elif kind in _EDGE_RATES:
            twav.write_wav(p, _speechlike(rng, n, 190.0 + 60 * k, noise=0.05),
                           _EDGE_RATES[kind])
        else:
            t = np.arange(n) / 44100
            x = np.stack([0.3 * np.sin(2 * np.pi * 170 * t),
                          0.2 * np.sin(2 * np.pi * 310 * t)])
            _write_float_wav(p, (x + rng.standard_normal(x.shape) * 0.05)
                             .astype(np.float32), 44100)
        paths.append(p)
    want, order, n_valid = _sequential_build(paths)
    assert order == list(range(len(paths)))
    assert want.shape[1] == tdecode._next_bucket(int(max(n_valid)), SR)
    y, qo = tden.gate_normalize_i16(torch.from_numpy(want), 0.4,
                                    torch.from_numpy(n_valid), sr=SR)
    info = {}
    h, b, m = tdecode.load_audio_many(paths, noise_reduction_amount=0.4,
                                      return_device=True, wire_info=info,
                                      staging_info=info, device="cpu")
    assert m == order and info["bytes_wire"] == want.size * 2
    assert info["rows_converted"] == sum(
        kind != "i16" for kind, _ in _EDGE_ROWS[case])
    assert torch.equal(b, y)
    host = qo.numpy().astype(np.float32) / 32767.0
    for row, n in enumerate(n_valid):
        np.testing.assert_array_equal(h[row], host[row, :n])
        assert not b[row, n:].any() and not qo[row, n:].any()
    h_j, b_j, m_j = jdecode.load_audio_many(paths, noise_reduction_amount=0.4,
                                            return_device=True, wire_bits=16)
    assert m_j == m
    np.testing.assert_allclose(b.numpy(), np.asarray(b_j), atol=1e-4)
    for a, r in zip(h, h_j):
        np.testing.assert_allclose(a, np.asarray(r), atol=1e-4)


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
                                device="cpu", staging_info=info)
        seen.append(info["staging_reused"])
        if batch == paths[3:]:
            st, q = _staged(batch)
            assert st.reused and q.shape == (2, SR)
            for row, p in enumerate(batch):
                x, _ = twav.read_wav_i16(p)
                np.testing.assert_array_equal(q[row, : len(x)], x)
                assert not q[row, len(x):].any()
    assert seen == [0, 1, 0]


def test_staging_counts_every_loaded_row(wav_mix):
    """rows_direct + rows_converted is the number of files that loaded; the
    staging counters leave wire_info as the JAX package writes it."""
    info, wire = {}, {}
    h = tdecode.load_audio_many(wav_mix, device="cpu", staging_info=info,
                                wire_info=wire)
    wire_j = {}
    jdecode.load_audio_many(wav_mix, wire_bits=16, wire_info=wire_j)
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
