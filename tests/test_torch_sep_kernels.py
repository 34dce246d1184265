"""The separator's two kernels on the CPU (ops/sb_attention.py,
ops/sb_ffn.py): their arithmetic emulated in plain PyTorch as the kernels
tile it, held against the float32 layers they replace; the operand layout
the FFN kernel reads; the wrappers' plain route giving the segment blocks'
output bit for bit as before the kernels; the launch counters at 0; and
the input checks. The kernels themselves run in tests/test_torch_cuda.py.

One torch thread, TF32 off. The FFN's 3xTF32 arithmetic (K1's
``split_tf32``: every product as lo*hi + hi*lo + hi*hi of exact TF32
halves) stays within 1e-6 of the float32 sublayer's output, relative to
its norm; one TF32 product a product misses that by two orders.
"""

import pytest
import torch
import torch.nn.functional as F

from clearconverse_tpu_torch.models import resepformer as rsf
from clearconverse_tpu_torch.ops import logmel as k1
from clearconverse_tpu_torch.ops import sb_attention as sba
from clearconverse_tpu_torch.ops import sb_ffn as sbf

PUBLISHED = rsf.ResepformerDims()
TINY = rsf.ResepformerDims(enc_channels=16, n_heads=2, d_ffn=32,
                           segment_size=6, n_layers=2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = mm
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _ffn_weights(seed, d=128, f=1024):
    """A layer drawn as the benchmark's family draws the separator: fan-in
    scaled matrices, small biases, gains about 1."""
    g = _gen(seed)
    return (1 + 0.1 * torch.randn(d, generator=g),
            0.02 * torch.randn(d, generator=g),
            torch.randn((f, d), generator=g) * d ** -0.5,
            0.02 * torch.randn(f, generator=g),
            torch.randn((d, f), generator=g) * f ** -0.5,
            0.02 * torch.randn(d, generator=g))


def _split(x):
    """K1's ``split_tf32`` on a torch tensor."""
    return tuple(torch.from_numpy(a) for a in k1.split_tf32(x.numpy()))


def _unswizzle(t):
    """Tiles [..., rows, 8] (rows a multiple of 8) with K1's 32-byte
    swizzle undone (it is its own inverse)."""
    return torch.from_numpy(k1.sw32(t.reshape(-1, 8).numpy())).reshape(t.shape)


def _tile(stage, offset, rows):
    """One [rows, 8] tile of a stage as the kernel's wgmma reads it."""
    return _unswizzle(stage[offset: offset + rows * 8].reshape(rows, 8))


def unpack_operands(ops, d_ffn, d_model=128):
    """``ffn_operands``' inverse: (fc1 hi, fc1 lo, fc2 hi, fc2 lo) in the
    weights' own layout."""
    nc = d_ffn // sbf.CHUNK
    st = ops.reshape(nc, sbf.STAGES_PER_CHUNK, sbf.STAGE_FLOATS)
    t1 = _unswizzle(st[:, :2].reshape(nc, d_model // 8, 2, sbf.CHUNK, 8))
    w1 = t1.permute(2, 0, 3, 1, 4).reshape(2, d_ffn, d_model)
    t2 = _unswizzle(st[:, 2:].reshape(nc, sbf.CHUNK // 8, 2, d_model, 8))
    t2 = t2.permute(2, 3, 0, 1, 4)                        # [2, D, nc, 8, 8]
    inv = torch.argsort(torch.tensor(sbf.W2_PERM))
    w2 = t2[..., inv].reshape(2, d_model, d_ffn)
    return w1[0], w1[1], w2[0], w2[1]


def emulate_ffn(h, ln_w, ln_b, ops, b1, b2, products=3):
    """The FFN kernel's arithmetic from its operand buffer: x̂ split into
    TF32 halves against fc1's [64 units, 8] tiles a chunk; bias, ReLU and
    the hidden split into halves whose k-slots are the accumulator's
    columns (slot s: unit 2s, slot s + 4: unit 2s + 1) against fc2's [128,
    8] tiles; each chunk's part summed apart and added to the output. With
    ``products=1`` every product is the one TF32 product hi*hi."""
    d = h.shape[-1]
    f = b1.numel()
    nc = f // sbf.CHUNK
    st = ops.reshape(nc, sbf.STAGES_PER_CHUNK, sbf.STAGE_FLOATS)
    x = F.layer_norm(h, (d,), ln_w, ln_b, 1e-6)
    xh, xl = _split(x)

    def prod(ah, al, bh, bl):
        if products == 1:
            return ah @ bh.T
        return (al @ bh.T + ah @ bl.T) + ah @ bh.T

    slot_unit = torch.tensor(sbf.W2_PERM)
    acc = torch.zeros_like(h)
    for c in range(nc):
        hid = torch.zeros(h.shape[0], sbf.CHUNK)
        for q in range(d // 8):
            s, q8 = divmod(q, 8)
            w_hi = _tile(st[c, s], q8 * 1024, sbf.CHUNK)
            w_lo = _tile(st[c, s], q8 * 1024 + 512, sbf.CHUNK)
            cols = slice(8 * q, 8 * q + 8)
            hid = hid + prod(xh[:, cols], xl[:, cols], w_hi, w_lo)
        hd = F.relu(hid + b1[c * sbf.CHUNK:(c + 1) * sbf.CHUNK])
        hh, hl = _split(hd)
        part = torch.zeros_like(h)
        for i in range(sbf.CHUNK // 8):
            s, u = divmod(i, 4)
            w_hi = _tile(st[c, 2 + s], u * 2048, d)
            w_lo = _tile(st[c, 2 + s], u * 2048 + 1024, d)
            units = 8 * i + slot_unit
            part = part + prod(hh[:, units], hl[:, units], w_hi, w_lo)
        acc = acc + part
    return (acc + b2) + h


def _rel(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("products,within", [(3, True), (1, False)],
                         ids=["3xtf32", "1xtf32"])
def test_ffn_emulation_matches_f32_sublayer(products, within):
    """At published widths (128 → 1024 → 128), 300 rows (two segments)."""
    p = _ffn_weights(3)
    h = torch.randn((300, 128), generator=_gen(4))
    want = sbf.sb_ffn_plain(h, *p)
    ops = torch.from_numpy(sbf.ffn_operands(p[2], p[4]))
    got = emulate_ffn(h, p[0], p[1], ops, p[3], p[5], products)
    err = _rel(got, want)
    if within:
        assert err <= 1e-6, err
    else:
        assert err > 1e-4, err


def test_ffn_operands_hold_the_split_weights():
    """``ffn_operands`` lays out every TF32 half of both weights (K1's
    ``split_tf32``) once, in n_chunks x 4 stages: its inverse gives them
    back exactly, each half exactly TF32."""
    p = _ffn_weights(5)
    ops = torch.from_numpy(sbf.ffn_operands(p[2], p[4]))
    assert ops.numel() == 1024 // sbf.CHUNK * sbf.STAGES_PER_CHUNK \
        * sbf.STAGE_FLOATS
    halves = _split(p[2]) + _split(p[4])
    for got, want in zip(unpack_operands(ops, 1024), halves):
        assert torch.equal(got, want)
        assert not (got.view(torch.int32) & 0x1FFF).any()
    for w, (hi, lo) in ((p[2], halves[:2]), (p[4], halves[2:])):
        assert float(((hi + lo) - w).abs().max()) <= 2 ** -21 * float(
            w.abs().max())


def test_ffn_operands_follow_the_weights():
    """The split is kept while the weights stand and made again after an
    in-place change (a checkpoint's ``copy_``)."""
    p = _ffn_weights(6)
    w1, w2 = p[2].clone(), p[4].clone()
    first = sbf.operands(w1, w2)
    assert sbf.operands(w1, w2) is first
    with torch.no_grad():
        w2.mul_(0.5)
    again = sbf.operands(w1, w2)
    assert again is not first
    assert torch.equal(again, torch.from_numpy(sbf.ffn_operands(w1, w2)))


def emulate_attention(qkv, n_heads, chunk=16):
    """The attention kernel's arithmetic: per (segment, head, query), q
    scaled by 16^-0.5, keys in chunks of 16 (zero-padded past T, their
    scores -inf) under an online softmax, the output divided by the sum at
    the end."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    dh = D // n_heads
    pad = -(-T // chunk) * chunk

    def heads(x):
        return x.reshape(B, T, n_heads, dh).transpose(1, 2)

    q = heads(qkv[..., :D]) * dh ** -0.5
    k = F.pad(heads(qkv[..., D:2 * D]), (0, 0, 0, pad - T))
    v = F.pad(heads(qkv[..., 2 * D:]), (0, 0, 0, pad - T))
    m = torch.full((B, n_heads, T), float("-inf"))
    l = torch.zeros((B, n_heads, T))
    acc = torch.zeros((B, n_heads, T, dh))
    for j0 in range(0, pad, chunk):
        s = q @ k[:, :, j0:j0 + chunk].transpose(-1, -2)
        s[..., torch.arange(j0, j0 + chunk) >= T] = float("-inf")
        mx = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - mx)
        p = torch.exp(s - mx[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ v[:, :, j0:j0 + chunk]
        m = mx
    return (acc / l[..., None]).transpose(1, 2).reshape(B, T, D)


@pytest.mark.parametrize("T", [150, 17, 256, 1])
def test_attention_emulation_matches_sb_mha(T):
    """Random segments at the published widths (8 heads of 16) through
    ``_sb_mha``'s projections: the kernel's tiling within 2e-6 of the
    layer's plain attention."""
    g = _gen(T)
    att = torch.nn.MultiheadAttention(128, 8, bias=True)
    with torch.no_grad():
        att.in_proj_weight.copy_(torch.randn((384, 128), generator=g) * 0.3)
        att.in_proj_bias.copy_(0.02 * torch.randn(384, generator=g))
    x = torch.randn((5, T, 128), generator=g)
    with torch.no_grad():
        want = rsf._sb_mha(x, att, None)
        qkv = F.linear(x, att.in_proj_weight, att.in_proj_bias)
        got = F.linear(emulate_attention(qkv, 8), att.out_proj.weight,
                       att.out_proj.bias)
    assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())


def _sb_block_before(x, blk, ok=None):
    """``_sb_block`` as the port computed it before the kernels: the
    attention and the FFN written out in PyTorch operations."""
    pe = rsf._sb_positional_cpu(x.shape[1], x.shape[2]).to(x.device, x.dtype)
    h = x + pe
    for lyr in blk.mdl.layers:
        y = rsf._sb_layer_norm(h, lyr.norm1)
        att = lyr.self_att.att
        B, T, D = y.shape
        H = att.num_heads
        dh = D // H
        q, k, v = F.linear(y, att.in_proj_weight, att.in_proj_bias).chunk(3, -1)
        q = q.reshape(B, T, H, dh).transpose(1, 2) * dh ** -0.5
        k = k.reshape(B, T, H, dh).transpose(1, 2)
        v = v.reshape(B, T, H, dh).transpose(1, 2)
        s = torch.matmul(q, k.transpose(-1, -2))
        if ok is not None:
            s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
        o = torch.matmul(torch.softmax(s, dim=-1), v)
        h = h + F.linear(o.transpose(1, 2).reshape(B, T, D),
                         att.out_proj.weight, att.out_proj.bias)
        ffn = lyr.pos_ffn.ffn
        h = h + F.linear(F.relu(F.linear(rsf._sb_layer_norm(h, lyr.norm2),
                                         ffn[0].weight, ffn[0].bias)),
                         ffn[3].weight, ffn[3].bias)
    h = rsf._sb_layer_norm(h, blk.mdl.norm)
    return rsf._global_norm(h, blk.norm, ok) + x


@pytest.mark.parametrize("dims", [PUBLISHED, TINY], ids=["published", "tiny"])
@pytest.mark.parametrize("block", ["segment", "memory"])
def test_sb_block_on_cpu_is_unchanged_bit_for_bit(dims, block):
    """On CPU tensors both wrappers run their plain versions: a segment
    block (unmasked, T = K) and the memory block (masked keys) give what
    they gave before the kernels, bit for bit."""
    model = rsf.init_resepformer(dims, seed=2, device="cpu")
    pipe = model.masknet.model
    g = _gen(7)
    d = dims.d_model
    if block == "segment":
        blk, ok = pipe.seg_model[1], None
        x = torch.randn((3, dims.segment_size, d), generator=g)
    else:
        blk = pipe.mem_model[0]
        x = torch.randn((2, 7, d), generator=g)
        ok = torch.arange(7)[None, :] < torch.tensor([7, 4])[:, None]
    assert torch.equal(rsf._sb_block(x, blk, ok), _sb_block_before(x, blk, ok))


def test_launch_counters_stay_at_zero_on_the_cpu():
    model = rsf.init_resepformer(PUBLISHED, seed=1, device="cpu")
    mix = torch.randn((2, 4000), generator=_gen(8)) * 0.3
    before = (sba.seg_attention.launches, sbf.sb_ffn.launches)
    out = rsf.sepformer_separate(model, mix, torch.tensor([4000, 2500]))
    assert out.shape == (2, 4000, 2) and torch.isfinite(out).all()
    assert (sba.seg_attention.launches, sbf.sb_ffn.launches) == before


def _bad_attention():
    x = torch.zeros((2, 150, 384))
    return {
        "dtype": (x.double(), 8),
        "rank": (x[0], 8),
        "keys": (torch.zeros((1, 257, 384)), 8),
        "head_width": (torch.zeros((1, 150, 192)), 8),
        "empty": (torch.zeros((0, 150, 384)), 8),
        "strided": (torch.zeros((2, 384, 150)).transpose(1, 2), 8),
    }


@pytest.mark.parametrize("case", sorted(_bad_attention()))
def test_attention_check_rejects(case):
    qkv, heads = _bad_attention()[case]
    with pytest.raises(ValueError):
        sba.check(qkv, heads)


def _bad_ffn():
    p = list(_ffn_weights(9, f=256))
    h = torch.zeros((10, 128))

    def with_(i, v):
        q = list(p)
        q[i] = v
        return (h, *q)

    return {
        "dtype": (h.double(), *p),
        "width": (torch.zeros((10, 64)), *p),
        "d_ffn": (h, *_ffn_weights(9, f=96)),
        "fc2_shape": with_(4, p[4].T.contiguous()),
        "bias_shape": with_(3, p[3][:64]),
        "strided_rows": (torch.zeros((128, 10)).T, *p),
        "strided_weight": with_(2, p[2].T.contiguous().T),
    }


@pytest.mark.parametrize("case", sorted(_bad_ffn()))
def test_ffn_check_rejects(case):
    with pytest.raises(ValueError):
        sbf.check(*_bad_ffn()[case])


def test_wrappers_take_the_cpu_and_cuda_only():
    p = _ffn_weights(10, f=128)
    with pytest.raises(ValueError, match="unsupported device"):
        sba.seg_attention(torch.zeros((1, 150, 384), device="meta"), 8)
    with pytest.raises(ValueError, match="unsupported device"):
        sbf.sb_ffn(torch.zeros((4, 128), device="meta"), *p)
    assert sba.check(torch.zeros((2, 150, 384)), 8) is None
    assert sbf.check(torch.zeros((4, 150, 128)), *p) is None
