"""Voxtral's loop-step attention (ops/decode_attention.py) on the CPU.

Held here: the plain version against a frozen copy of the attention block
that ``voxtral.step_forward`` ran before the kernel, bit for bit, the
suffix-slot writes included, at tiny widths and at the published head
widths; an emulation of the kernel's arithmetic, tiled as the kernel tiles
it (prefix key splits, 16-key tiles in stages of 4, the warps' key lanes,
an online softmax in f32 with the weights rounded to bf16, the warps'
merge and the splits' combine), against the plain version, and suffix
slots at or past the step, filled with NaN, kept out of its output; the
wrapper's input checks; the prefix split; the decode arena's position-major
layout and the prefill that writes it; ``fused_attn_layers`` 0 on the CPU.
The kernel itself runs in tests/test_torch_cuda.py.
"""

import math

import numpy as np
import pytest
import torch

from clearconverse_tpu_torch.models import decode_graph
from clearconverse_tpu_torch.models import voxtral as vx
from clearconverse_tpu_torch.models.whisper import matmul_f32
from clearconverse_tpu_torch.ops import decode_attention as da


def _frozen_block(q, k, v, cos, sin, step, pre, suf, kslot, H, dh):
    """``step_forward``'s attention block before the kernel, verbatim:
    ``pre`` {"k": [U, H, P, dh] view of head-major storage, "v"}, ``suf``
    {"kt": [U, H, R, dh, M], "v": [U, H, R, M, dh]}."""
    B = q.shape[0]
    U = pre["v"].shape[0]
    R = B // U
    n_head = q.shape[1] // dh
    g = n_head // H
    M = kslot.shape[0]
    slot = (step - 1).reshape(1)
    smask = torch.where(kslot >= step, -1e9, 0.0)
    scale = dh ** -0.5
    q = vx.apply_rope(q.view(B, n_head, dh), cos, sin)
    k = vx.apply_rope(k.view(B, H, dh), cos, sin)
    v = v.view(B, H, dh)
    k = k.view(U, R, H, dh).permute(0, 2, 1, 3)
    v = v.view(U, R, H, dh).permute(0, 2, 1, 3)
    suf["kt"].index_copy_(4, slot, k[..., None].to(suf["kt"].dtype))
    suf["v"].index_copy_(3, slot, v[..., None, :].to(suf["v"].dtype))
    qf = q.reshape(B, H, g, dh).view(U, R, H, g, dh).permute(0, 2, 1, 3, 4) \
        .contiguous()
    sp = matmul_f32(qf.view(U, H, R * g, dh), pre["k"].transpose(2, 3))
    ss = matmul_f32(qf, suf["kt"]) + smask
    logits = torch.cat([sp.view(U, H, R, g, -1), ss], dim=-1) * scale
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    wp = w[..., :-M].reshape(U, H, R * g, -1)
    o = (matmul_f32(wp, pre["v"]).view(U, H, R, g, dh)
         + matmul_f32(w[..., -M:].contiguous(), suf["v"]))
    return o.to(q.dtype).permute(0, 2, 1, 3, 4).reshape(B, n_head * dh)


def _case(U, R, H, g, dh, P, M, step, seed, dtype=torch.bfloat16):
    """Inputs of one layer's step: q, k, v, cos, sin, step, the prefix's
    head-major K and V, and a suffix whose slots below step - 1 are
    written (the rest zero, as a fresh cache leaves them)."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dtype)

    B = U * R
    dims = vx.VoxtralDims(head_dim=dh)
    cos, sin = vx.rope_tables(dims, torch.tensor(P + step - 1))
    suf_kt, suf_v = t(U, H, R, dh, M), t(U, H, R, M, dh)
    suf_kt[..., step - 1:] = 0
    suf_v[..., step - 1:, :] = 0
    return dict(q=t(B, H * g * dh), k=t(B, H * dh), v=t(B, H * dh), cos=cos,
                sin=sin, step=torch.tensor(step), pre_kt=t(U, H, dh, P),
                pre_v=t(U, H, P, dh), suf_kt=suf_kt, suf_v=suf_v,
                kslot=torch.arange(M))


def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32)


def _plain(c):
    """The plain version on the case's caches as the CPU holds them: K's
    storage head-major, ``"k"`` its position-major view."""
    pre = {"k": c["pre_kt"].transpose(2, 3), "v": c["pre_v"]}
    suf = {"k": c["suf_kt"].transpose(3, 4), "v": c["suf_v"]}
    out = da.decode_attention(c["q"], c["k"], c["v"], c["cos"], c["sin"],
                              c["step"], pre, suf, c["kslot"])
    return out, suf


# (U, R, H, g, dh, P, M, step): tiny widths, then the published heads (128
# wide, 4 query heads a K/V head) at small U, R, P.
PLAIN_CASES = [(2, 3, 2, 2, 16, 11, 7, 1), (2, 3, 2, 2, 16, 11, 7, 4),
               (1, 1, 1, 4, 16, 5, 3, 3), (2, 5, 2, 4, 128, 23, 9, 5),
               (3, 1, 1, 4, 128, 17, 6, 6)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", PLAIN_CASES)
def test_plain_version_is_the_frozen_block_bit_for_bit(shape, dtype):
    U, R, H, g, dh, P, M, step = shape
    c = _case(U, R, H, g, dh, P, M, step, seed=sum(shape), dtype=dtype)
    frozen = {"kt": c["suf_kt"].clone(), "v": c["suf_v"].clone()}
    want = _frozen_block(c["q"], c["k"], c["v"], c["cos"], c["sin"],
                         c["step"], {"k": c["pre_kt"].transpose(2, 3),
                                     "v": c["pre_v"]}, frozen, c["kslot"],
                         H, dh)
    got, suf = _plain(c)
    assert got.dtype == dtype and got.shape == (U * R, H * g * dh)
    assert torch.equal(_bits(got), _bits(want))
    # The slot writes: the same bytes in the same (head-major) storage.
    assert torch.equal(_bits(suf["k"].transpose(3, 4)), _bits(frozen["kt"]))
    assert torch.equal(_bits(suf["v"]), _bits(frozen["v"]))
    assert suf["k"].transpose(3, 4).is_contiguous()
    assert not torch.equal(frozen["kt"][..., step - 1],
                           torch.zeros_like(frozen["kt"][..., step - 1]))


# ------------------------------------------------------------ emulation

def _rope_bf16(x, cos, sin):
    """The kernel's RoPE: f32 products and sum, each rounded, then bf16."""
    x32 = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * cos + rot * sin).to(torch.bfloat16)


def _emulate(q, k, v, cos, sin, step, pk, pv, sk, sv, n_split, split_keys):
    """The kernel's arithmetic, tiled as it tiles it, on position-major
    caches (pk, pv [U, H, P, 128], sk, sv [U, H, R, M, 128]; sk, sv
    written in place). Returns the bf16 [B, 4 H 128] output."""
    G, D, T, W = da.GROUP, da.HEAD_DIM, 16, 4
    B = q.shape[0]
    U, H, P, _ = pk.shape
    R, M = sk.shape[2], sk.shape[3]
    s_now = int(step)
    scale_log2 = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32) \
        * torch.tensor(1.4426950408889634, dtype=torch.float32)
    qr = _rope_bf16(q.view(B, H * G, D), cos, sin).float()
    kr = _rope_bf16(k.view(B, H, D), cos, sin)
    if 1 <= s_now <= M:
        for u in range(U):
            for r in range(R):
                sk[u, :, r, s_now - 1] = kr[u * R + r]
                sv[u, :, r, s_now - 1] = v.view(B, H, D)[u * R + r]
    out = torch.empty(B, H * G, D, dtype=torch.bfloat16)
    for u in range(U):
        for h in range(H):
            parts = []     # per job: (rows, m [rows], l [rows], o [rows, D])
            jobs = [("p", j) for j in range(n_split)] + \
                [("s", r) for r in range(R)]
            for kind, j in jobs:
                if kind == "p":
                    key0 = j * split_keys
                    n = min(P - key0, split_keys)
                    kk, vv = pk[u, h, key0:key0 + n], pv[u, h, key0:key0 + n]
                    rows = [(r, gg) for r in range(R) for gg in range(G)]
                else:
                    n = max(0, min(s_now, M))
                    kk, vv = sk[u, h, j, :n], sv[u, h, j, :n]
                    rows = [(j, gg) for gg in range(G)]
                qm = torch.stack([qr[u * R + r, h * G + gg]
                                  for r, gg in rows])
                n_mt = -(-len(rows) // 16)
                nk = W // n_mt
                n_tiles = -(-n // T)
                lanes = []
                for kl in range(nk):
                    m = torch.full((len(rows),), -math.inf)
                    l = torch.zeros(len(rows))
                    o = torch.zeros(len(rows), D)
                    for tile in range(kl, n_tiles, nk):
                        # A tile's keys past the job's end are zero-filled.
                        kt = torch.zeros(T, D, dtype=torch.bfloat16)
                        vt = torch.zeros(T, D, dtype=torch.bfloat16)
                        valid = min(T, n - tile * T)
                        kt[:valid] = kk[tile * T:tile * T + valid]
                        vt[:valid] = vv[tile * T:tile * T + valid]
                        s = (qm @ kt.float().T) * scale_log2
                        s[:, valid:] = -math.inf
                        mx = torch.maximum(m, s.max(-1).values)
                        corr = torch.exp2(m - mx)
                        p = torch.exp2(s - mx[:, None])
                        l = l * corr + p.sum(-1)
                        o = o * corr[:, None] + (
                            p.to(torch.bfloat16).float() @ vt.float())
                        m = mx
                    lanes.append((m, l, o))
                ms = torch.stack([x[0] for x in lanes])
                m = ms.max(0).values
                f = torch.where(m == -math.inf, 0.0, torch.exp2(ms - m))
                l = (torch.stack([x[1] for x in lanes]) * f).sum(0)
                o = (torch.stack([x[2] for x in lanes]) * f[..., None]).sum(0)
                parts.append((rows, m, l, o))
            for r in range(R):
                for gg in range(G):
                    got = [(pm[i], pl[i], po[i]) for rows, pm, pl, po in parts
                           for i, rw in enumerate(rows) if rw == (r, gg)]
                    ms = torch.stack([x[0] for x in got])
                    m = ms.max()
                    f = torch.where(ms == -math.inf, 0.0, torch.exp2(ms - m))
                    l = (torch.stack([x[1] for x in got]) * f).sum()
                    o = (torch.stack([x[2] for x in got]) * f[:, None]).sum(0)
                    out[u * R + r, h * G + gg] = (o / l).to(torch.bfloat16)
    return out.view(B, H * G * D)


def _emulated(c, n_split, split_keys):
    """The emulation on the case's caches laid out position-major, as the
    card's arena holds them. Returns (output, suffix K, suffix V)."""
    sk = c["suf_kt"].transpose(3, 4).contiguous()
    sv = c["suf_v"].clone()
    out = _emulate(c["q"], c["k"], c["v"], c["cos"], c["sin"], c["step"],
                   c["pre_kt"].transpose(2, 3).contiguous(), c["pre_v"], sk, sv,
                   n_split, split_keys)
    return out, sk, sv


# The emulation against the plain version, as a share of the output's
# largest magnitude. The two round the softmax weights to bf16 at different
# points (the plain version its normalised weights, the kernel its
# unnormalised ones, each within 2^-9 relative) and sum in other orders,
# then round the output once to bf16 (2^-8 relative): a handful of bf16
# ulps of the output's scale at most. Over these cases and three seeds the
# emulation reads 3.1e-3 to 6.8e-3 (one bf16 ulp of the largest output is
# 3.9e-3); the tolerance is 1.5e-2.
EMU_TOL = 1.5e-2

# (U, R, H, P, M, step, split keys): the published heads; the prefix cut
# into 1, 3 or 4 runs; R = 5 (two m16 tiles, two key lanes) and R = 1 (one
# tile, four lanes); steps from the first to the suffix's end.
EMU_CASES = [(1, 5, 1, 40, 24, 1, 16), (2, 5, 1, 40, 24, 7, 14),
             (1, 5, 2, 70, 40, 33, 64), (1, 1, 1, 37, 24, 24, 128),
             (2, 3, 1, 20, 70, 66, 7)]


@pytest.mark.parametrize("shape", EMU_CASES)
def test_kernel_emulation_matches_the_plain_version(shape):
    U, R, H, P, M, step, split_keys = shape
    c = _case(U, R, H, da.GROUP, da.HEAD_DIM, P, M, step, seed=7 + step)
    n_split = -(-P // split_keys)
    want, suf = _plain(c)
    got, sk, sv = _emulated(c, n_split, split_keys)
    # The suffix slot holds the plain version's bytes exactly.
    assert torch.equal(sk, suf["k"]) and torch.equal(sv, suf["v"])
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    assert err < EMU_TOL, err


def test_unwritten_suffix_slots_never_reach_the_output():
    U, R, H, P, M, step = 2, 5, 1, 30, 20, 9
    c = _case(U, R, H, da.GROUP, da.HEAD_DIM, P, M, step, seed=3)
    clean, _, _ = _emulated(c, 2, 16)
    c["suf_kt"][..., step:] = float("nan")
    c["suf_v"][..., step:, :] = float("nan")
    dirty, sk, _ = _emulated(c, 2, 16)
    assert bool(torch.isfinite(dirty.float()).all())
    assert torch.equal(dirty, clean)
    assert bool(torch.isnan(sk[..., step:, :].float()).all())


# ------------------------------------------------------------ the wrapper

def _good(U=2, R=5, H=2, P=21, M=9):
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)

    D = da.HEAD_DIM
    return dict(q=t(U * R, da.GROUP * H * D), k=t(U * R, H * D),
                v=t(U * R, H * D), cos=torch.ones(D), sin=torch.zeros(D),
                step=torch.tensor(3),
                prefix={"k": t(U, H, P, D), "v": t(U, H, P, D)},
                suffix={"k": t(U, H, R, M, D), "v": t(U, H, R, M, D)})


def _bad(name):
    a = _good()
    D = da.HEAD_DIM
    if name == "q_f32":
        a["q"] = a["q"].float()
    elif name == "head_dim_64":
        a = _good()
        for key in ("prefix", "suffix"):
            a[key] = {n: x[..., :64].contiguous() for n, x in a[key].items()}
    elif name == "group_2":
        a["q"] = a["q"][:, : 2 * 2 * D].contiguous()
    elif name == "replicas_9":
        a = _good(R=9)
    elif name == "prefix_head_major":
        a["prefix"]["k"] = a["prefix"]["k"].transpose(2, 3).contiguous() \
            .transpose(2, 3)
    elif name == "suffix_strided":
        a["suffix"]["v"] = a["suffix"]["v"].transpose(0, 1)
    elif name == "step_1d":
        a["step"] = a["step"].reshape(1)
    elif name == "step_int32":
        a["step"] = a["step"].int()
    elif name == "cos_bf16":
        a["cos"] = a["cos"].to(torch.bfloat16)
    elif name == "rows_not_u_r":
        a["k"] = a["k"][:-1].contiguous()
    elif name == "suffix_other_rows":
        a["suffix"] = {n: x[:1].contiguous() for n, x in a["suffix"].items()}
    elif name == "misaligned":
        a["v"] = torch.empty(a["v"].numel() + 1, dtype=torch.bfloat16)[1:] \
            .view(a["v"].shape)
    return a


@pytest.mark.parametrize("name", [
    "q_f32", "head_dim_64", "group_2", "replicas_9", "prefix_head_major",
    "suffix_strided", "step_1d", "step_int32", "cos_bf16", "rows_not_u_r",
    "suffix_other_rows", "misaligned"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(name):
    da.check(**_good())           # the good call passes
    with pytest.raises(ValueError, match="decode_attention"):
        da.check(**_bad(name))


def test_the_wrapper_refuses_another_device():
    a = _good()
    q = a.pop("q").to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        da.decode_attention(q, **a, kslot=torch.arange(9))


@pytest.mark.parametrize("P", [1, 15, 128, 129, 387, 1000])
def test_the_prefix_split_covers_the_prompt_evenly(P):
    n, keys = da.prefix_split(P)
    assert keys <= da.SPLIT_KEYS and n * keys >= P > (n - 1) * keys
    assert n == -(-P // da.SPLIT_KEYS)
    assert P - (n - 1) * keys >= keys - n      # the last run is not starved


# ------------------------------------------------------------ the route

def test_the_arena_holds_k_position_major():
    layout = decode_graph.PrefixLayout(3, 2, 16, torch.bfloat16)
    arena = decode_graph._PrefixArena(layout, 2 * 2 * 16 * 7, 2 * 2 * 3 * 16 * 5,
                                      torch.device("cpu"))
    prefix, suffix = arena.views(2, 3, 7, 5)
    assert len(prefix) == len(suffix) == 3
    for layer in prefix:
        assert {n: tuple(t.shape) for n, t in layer.items()} == {
            "k": (2, 2, 7, 16), "v": (2, 2, 7, 16)}
        assert all(t.is_contiguous() for t in layer.values())
    for layer in suffix:
        assert {n: tuple(t.shape) for n, t in layer.items()} == {
            "k": (2, 2, 3, 5, 16), "v": (2, 2, 3, 5, 16)}
        assert all(t.is_contiguous() for t in layer.values())


TINY = vx.VoxtralDims(n_audio_state=64, n_audio_head=4, n_audio_layer=2,
                      d_model=48, n_layer=2, n_head=4, n_kv_head=2,
                      head_dim=16, d_ffn=96, n_vocab=1300)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_the_prefill_writes_the_arena_layout_without_changing_its_results(
        cdt):
    model = vx.init_voxtral(TINY, seed=2, device="cpu", dtype=cdt)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 9, TINY.d_model)).astype(np.float32))
    kv, logits = vx.prefix_prefill(model, x, cdt)
    H, dh = TINY.n_kv_head, TINY.head_dim
    layout = decode_graph.PrefixLayout(TINY.n_layer, H, dh, cdt)
    arena = decode_graph._PrefixArena(layout, 2 * H * dh * 9, 2 * H * dh,
                                      torch.device("cpu"))
    bufs, _ = arena.views(2, 1, 9, 1)
    kv_out, logits_out = vx.prefix_prefill(model, x, cdt, out=bufs)
    assert torch.equal(logits_out, logits)
    assert kv_out is not kv and len(kv_out) == TINY.n_layer
    for a, b, buf in zip(kv, kv_out, bufs):
        assert b["k"].data_ptr() == buf["k"].data_ptr()
        assert b["k"].is_contiguous() and not a["k"].is_contiguous()
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_fused_attn_layers_reads_0_on_the_cpu():
    from clearconverse_tpu_torch.models import decoding as dec
    from clearconverse_tpu_torch.models.tokenizer import (
        TekkenByteTokenizer, TekkenSpecials)
    from clearconverse_tpu_torch.utils.tracing import StageTimer
    tok = TekkenByteTokenizer(TekkenSpecials(n_vocab=TINY.n_vocab))
    head, tail = tok.specials.prompt(tok.language_ids("en"))
    model = vx.init_voxtral(TINY, seed=1, device="cpu", dtype=torch.float32)
    opts = dec.DecodeOptions(
        max_tokens=3, temperature=0.0, eot=tok.specials.eos,
        suppress_blank=False, suppress_tokens=tok.specials.control_ids(),
        compute_dtype=torch.float32, replicas=2)
    timer = StageTimer()
    launches = da.decode_attention.launches
    audio = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 16000)).astype(np.float32) * 0.1)
    out = dec.voxtral_decode_from_audio(model, audio, head, tail, opts,
                                        timer=timer)
    assert out["counts"]["fused_attn_layers"] == 0
    assert out["counts"]["steps"] == 2
    assert timer.counts["fused_attn_layers"] == 0
    assert da.decode_attention.launches == launches
