"""Voxtral's loop-step attention (csrc/decode_attention.cu).

A port-only kernel: Voxtral has no JAX counterpart. ``decode_attention``
takes one decoder layer's q, k and v projections of a loop step, ``q`` [B,
n_head * head_dim] and ``k``, ``v`` [B, n_kv * head_dim] in bf16 (B = U x R
rows, R replicas of each unique row consecutive), applies RoPE to q and k,
writes the step's k and v into suffix slot ``step`` - 1, attends each row to
its unique row's prefix and to its own suffix slots 0 .. ``step`` - 1, and
returns the [B, n_head * head_dim] bf16 input of the o projection. For a
CUDA tensor it launches the kernel (two launches: the key splits, then
their combine); for a CPU tensor it runs ``decode_attention_plain``, the
step's attention block as it was written before the kernel; it never falls
back from one to the other. ``decode_attention.launches`` counts the calls
that launched the kernel.

The caches are ``{"k", "v"}`` per layer, each position-major: prefix [U,
n_kv, P, head_dim], suffix [U, n_kv, R, M, head_dim]. The kernel reads them
contiguous (``check``); the plain version reads any strides, and the CPU's
caches keep K's storage head-major (``prefix_prefill``'s ``kt``,
``voxtral.suffix_cache``), as its products have always read it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict

import torch

from clearconverse_tpu_torch.models.whisper import matmul_f32
from clearconverse_tpu_torch.ops import build

HEAD_DIM = 128       # Voxtral's head width
GROUP = 4            # query heads a K/V head serves
MAX_REPLICAS = 8     # a prefix CTA's R x GROUP query rows: two m16 tiles
# Prefix keys a CTA reads at most (the cut is even): at P = 387 two splits
# of 194 keys. More splits write more f32 partials: on an H100 at U 32, R 5,
# M 136, steps 1 / 64 / 127 took 0.0680 / 0.0734 / 0.0804 ms with two
# splits, 0.0670 / 0.0742 / 0.0816 with one, 0.0781 / 0.0841 / 0.0909 with
# four.
SPLIT_KEYS = 256


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cc_vx_decode_attention.argtypes = [p] * 13 + [i] * 7 + [
        ctypes.c_float, p]
    lib.cc_vx_decode_attention.restype = i
    return lib


def prefix_split(P: int):
    """(splits, keys a split): the prefix's P keys cut into the fewest runs
    of at most SPLIT_KEYS, evened out (the last one may be shorter)."""
    keys = -(-P // -(-P // SPLIT_KEYS))
    return -(-P // keys), keys


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           cos: torch.Tensor, sin: torch.Tensor,
                           step: torch.Tensor, prefix: Dict[str, torch.Tensor],
                           suffix: Dict[str, torch.Tensor],
                           kslot: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: the loop step's attention block, op for
    op as ``voxtral.step_forward`` ran it before the kernel. ``kslot`` [M]
    is the suffix's slot index, whose slots at or past ``step`` the -1e9
    mask shuts out."""
    from clearconverse_tpu_torch.models.voxtral import _NEG_INF, apply_rope
    B = q.shape[0]
    U, H, _, dh = prefix["v"].shape
    R = B // U
    n_head = q.shape[1] // dh
    g = n_head // H
    M = kslot.shape[0]
    slot = (step - 1).reshape(1)
    smask = torch.where(kslot >= step, _NEG_INF, 0.0)     # [M]
    scale = dh ** -0.5
    q = apply_rope(q.view(B, n_head, dh), cos, sin)
    k = apply_rope(k.view(B, H, dh), cos, sin)
    v = v.view(B, H, dh)
    # [U, R, H, dh] → [U, H, R, dh]: each into its replica's slot step - 1.
    k = k.view(U, R, H, dh).permute(0, 2, 1, 3)
    v = v.view(U, R, H, dh).permute(0, 2, 1, 3)
    suffix["k"].index_copy_(3, slot, k[..., None, :].to(suffix["k"].dtype))
    suffix["v"].index_copy_(3, slot, v[..., None, :].to(suffix["v"].dtype))
    # [U, R, H, g, dh] → [U, H, R, g, dh]: replicas and groups folded.
    qf = q.view(U, R, H, g, dh).permute(0, 2, 1, 3, 4).contiguous()
    sp = matmul_f32(qf.view(U, H, R * g, dh), prefix["k"].transpose(2, 3))
    ss = matmul_f32(qf, suffix["k"].transpose(3, 4)) + smask  # [U,H,R,g,M]
    logits = torch.cat([sp.view(U, H, R, g, -1), ss], dim=-1) * scale
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    wp = w[..., :-M].reshape(U, H, R * g, -1)
    o = (matmul_f32(wp, prefix["v"]).view(U, H, R, g, dh)
         + matmul_f32(w[..., -M:].contiguous(), suffix["v"]))
    return o.to(q.dtype).permute(0, 2, 1, 3, 4).reshape(B, n_head * dh)


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          cos: torch.Tensor, sin: torch.Tensor, step: torch.Tensor,
          prefix: Dict[str, torch.Tensor],
          suffix: Dict[str, torch.Tensor]) -> None:
    """Raises ValueError unless the kernel takes the call: bf16 q [U R,
    GROUP H HEAD_DIM], k and v [U R, H HEAD_DIM]; f32 cos and sin
    [HEAD_DIM]; a 0-d int64 step; bf16 prefix K/V [U, H, P, HEAD_DIM] and
    suffix K/V [U, H, R, M, HEAD_DIM]; 1 <= R <= MAX_REPLICAS; every tensor
    contiguous, 16-byte aligned and on one device."""
    def need(ok: bool, what: str) -> None:
        if not ok:
            raise ValueError(f"decode_attention: {what}")

    pk, pv, sk, sv = prefix["k"], prefix["v"], suffix["k"], suffix["v"]
    tensors = {"q": q, "k": k, "v": v, "cos": cos, "sin": sin, "step": step,
               "prefix k": pk, "prefix v": pv, "suffix k": sk,
               "suffix v": sv}
    for name, t in tensors.items():
        want = (torch.float32 if name in ("cos", "sin") else
                torch.int64 if name == "step" else torch.bfloat16)
        need(t.dtype == want, f"{name} is {t.dtype}, want {want}")
        need(t.is_contiguous() and t.data_ptr() % 16 == 0,
             f"{name} must be contiguous and 16-byte aligned")
        need(t.device == q.device, f"{name} on {t.device}, q on {q.device}")
    need(step.dim() == 0, f"step must be 0-d, got {tuple(step.shape)}")
    need(cos.shape == sin.shape == (HEAD_DIM,),
         f"cos/sin {tuple(cos.shape)}, want ({HEAD_DIM},)")
    need(pk.dim() == 4 and pk.shape == pv.shape and pk.shape[-1] == HEAD_DIM,
         f"prefix K/V {tuple(pk.shape)} / {tuple(pv.shape)}, want [U, H, P, "
         f"{HEAD_DIM}] each")
    U, H, P, _ = pk.shape
    need(sk.dim() == 5 and sk.shape == sv.shape
         and sk.shape[:2] == (U, H) and sk.shape[-1] == HEAD_DIM,
         f"suffix K/V {tuple(sk.shape)} / {tuple(sv.shape)}, want [{U}, {H}, "
         f"R, M, {HEAD_DIM}] each")
    R, M = sk.shape[2], sk.shape[3]
    need(1 <= R <= MAX_REPLICAS, f"R={R} outside 1..{MAX_REPLICAS}")
    need(P >= 1 and M >= 1 and U * H <= 65535,
         f"P={P}, M={M}, U*H={U * H}: want P, M >= 1 and U*H <= 65535")
    B = U * R
    need(q.shape == (B, GROUP * H * HEAD_DIM),
         f"q {tuple(q.shape)}, want ({B}, {GROUP * H * HEAD_DIM}): heads of "
         f"{HEAD_DIM}, {GROUP} query heads a K/V head")
    need(k.shape == v.shape == (B, H * HEAD_DIM),
         f"k/v {tuple(k.shape)} / {tuple(v.shape)}, want ({B}, "
         f"{H * HEAD_DIM})")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor, step: torch.Tensor,
                     prefix: Dict[str, torch.Tensor],
                     suffix: Dict[str, torch.Tensor],
                     kslot: torch.Tensor) -> torch.Tensor:
    """One layer's loop-step attention (module docstring). CPU tensor: the
    plain version. CUDA tensor: the kernel, which takes what ``check``
    allows and raises otherwise; ``kslot``'s length must be the suffix's
    M."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, cos, sin, step, prefix, suffix,
                                      kslot)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    check(q, k, v, cos, sin, step, prefix, suffix)
    U, H, P, dh = prefix["k"].shape
    R, M = suffix["k"].shape[2], suffix["k"].shape[3]
    if kslot.shape != (M,):
        raise ValueError(f"decode_attention: kslot {tuple(kslot.shape)}, "
                         f"want ({M},)")
    n_split, split_keys = prefix_split(P)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_o = torch.empty((U * H, n_split + 1, R * GROUP, dh), **f32)
    part_ml = torch.empty((U * H, n_split + 1, R * GROUP, 2), **f32)
    out = torch.empty_like(q)
    rc = _lib().cc_vx_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), step.data_ptr(), prefix["k"].data_ptr(),
        prefix["v"].data_ptr(), suffix["k"].data_ptr(),
        suffix["v"].data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
        out.data_ptr(), U, H, R, P, M, n_split, split_keys,
        1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cc_vx_decode_attention launch failed: CUDA "
                           f"error {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
