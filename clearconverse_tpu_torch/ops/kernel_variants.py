"""Time text variants of a hand-written kernel against the kernel as built.

Each variant is the kernel's source (K2: ``csrc/encoder_attention.cu``, its
bf16 kernel; K1: ``csrc/logmel.cu``, its 80-mel instance) with a few
source lines replaced. All are built at once with ``build.NVCC_FLAGS`` into
``_build/variants/`` and called through the same C entry point as the
kernel. Variants marked diagnostic take work away (K2: the exponentials,
the softmax, the refills of the ring; K1: the products, the loads of the A
operands) and give wrong outputs: they time what is left. The others are
checked against the plain version (K2: atol 2e-3; K1: power rtol 2e-3 /
atol 1e-6 and log-mel atol 5e-4) before they are timed. Needs a CUDA
card; from the repository root:

    python3 -m clearconverse_tpu_torch.ops.kernel_variants [--kernel k1] [--batch 8 32]

Prints ptxas's registers and spills per variant, each variant's error, the
times (ms, three rounds in turn, with SDPA beside K2 and the plain version
beside K1) and, last, one JSON line that also holds the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

from clearconverse_tpu_torch.audio import mel as melmod
from clearconverse_tpu_torch.ops import build
from clearconverse_tpu_torch.ops import encoder_attention as k2
from clearconverse_tpu_torch.ops import logmel as k1

_WAIT = "    softmax_tile(s, m, l, corr, scale_log2, j * kTileK, t_len, col2);\n"
_FIRST_LOADS = [
    ("    if (loader && j - 1 + kStages < n_tiles) {", "    if (false) {"),
    ("    mbar_wait(&bars->full[st], (j / kStages) & 1);",
     "    if (j < min(n_tiles, kStages))\n"
     "      mbar_wait(&bars->full[st], (j / kStages) & 1);")]
_NO_SOFTMAX = [(_WAIT, "    corr[0] = corr[1] = 1.f;\n")]
# Twice the key tiles (the second pass reuses the ring's data): the time
# added is the steady-state cost of the tiles, the rest the CTA's fixed cost.
_TWICE = [("  for (int j = 1; j < n_tiles; ++j) {",
           "  for (int j = 1; j < 2 * n_tiles; ++j) {"),
          ("softmax_tile(s, m, l, corr, scale_log2, j * kTileK,",
           "softmax_tile(s, m, l, corr, scale_log2, (j % n_tiles) * kTileK,")]

# name -> (diagnostic, [(old, new), ...])
VARIANTS = {
    "as_built": (False, []),
    "stages2": (False, [("kStages = 4;", "kStages = 2;")]),
    "stages3": (False, [("kStages = 4;", "kStages = 3;")]),
    "two_consumers": (False, [("kConsumers = 3;", "kConsumers = 2;")]),
    "no_pingpong": (False, [
        ('asm volatile("bar.sync %0, 256;"',
         'if (id < 0) asm volatile("bar.sync %0, 256;"'),
        ('asm volatile("bar.arrive %0, 256;"',
         'if (id < 0) asm volatile("bar.arrive %0, 256;"')]),
    "softmax_before_pv_wait": (False, [
        (_WAIT + "    wgmma_wait<0>();",
         _WAIT + "    if (!(l[0] + l[1] > 0.f)) __trap();\n    wgmma_wait<0>();")]),
    "no_exp": (True, [("        x = ex2(fmaf(x, scale_log2, -m_new));",
                       "        x = fmaf(x, scale_log2, -m_new);")]),
    "no_softmax": (True, _NO_SOFTMAX),
    "loads_once": (True, _FIRST_LOADS),
    "loads_once_no_softmax": (True, _FIRST_LOADS + _NO_SOFTMAX),
    "loads_once_twice": (True, _FIRST_LOADS + _TWICE),
    "loads_once_no_softmax_twice": (True, _FIRST_LOADS + _NO_SOFTMAX + _TWICE[:1]),
}


_K1_PRODUCTS = [
    ("""        wgmma_tf32(re, el, b, q > 0);
        wgmma_tf32(re, eh, b + kT, 1);
        wgmma_tf32(re, eh, b, 1);
        wgmma_tf32(im, ol, b + 2 * kT, q > 0);
        wgmma_tf32(im, oh, b + 3 * kT, 1);
        wgmma_tf32(im, oh, b + 2 * kT, 1);
""", ""),
    ("""        wgmma_tf32(mel, al[u], b, 1);
        wgmma_tf32(mel, ah[u], b + (S::kFbTile >> 4), 1);
        wgmma_tf32(mel, ah[u], b, 1);
""", "")]

# K1 (80-mel instance): name -> (diagnostic, [(old, new), ...]). "unfolded"
# takes the full 400-sample DFT (50 k8-steps, not 26) and runs on
# logmel.kernel_operands(80, folded=False).
K1_VARIANTS = {
    "as_built": (False, []),
    "unfolded": (False, [
        ("kFold = 208;", "kFold = 400;"),
        ("          const float* pn = xr + n + (n >= kHop ? 4 : 0);",
         "          const float* pn = xr + n + 4 * (n / kHop);"),
        ("""            split(xn + xm, eh[j], el[j]);
            split(xn - xm, oh[j], ol[j]);""",
         """            split(xn, eh[j], el[j]);
            oh[j] = eh[j];
            ol[j] = el[j];""")]),
    "one_loader": (False, [
        ("  constexpr int kWarps = kThreads / 32;\n  const bool loader = tid % 32 == 0;",
         "  constexpr int kWarps = 1;\n  const bool loader = tid == 0;")]),
    "no_products": (True, _K1_PRODUCTS),
    "no_a_loads": (True, [(
        "            const float xn = pn[8 * kStride * rr], xm = pm[8 * kStride * rr];",
        "            const float xn = 1e-3f * q + rr, xm = 0.5f * half;")]),
}

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel -> (source, variants, kernel symbol in ptxas's log, C entry point,
# its argument types)
KERNELS = {
    "k2": ("encoder_attention.cu", VARIANTS, "attention_bf16_kernel",
           "cc_encoder_attention_bf16",
           [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P]),
    "k1": ("logmel.cu", K1_VARIANTS, "mel_power_kernelILi80", "cc_mel_power",
           [_P, _I, _I, _P, ctypes.c_longlong, _I, _P, _P]),
}


def variant_source(name: str, kernel: str = "k2") -> str:
    """The kernel's source with variant ``name``'s lines replaced; raises if
    a line to replace is not in the source exactly once."""
    source, variants = KERNELS[kernel][:2]
    text = (build.CSRC / source).read_text()
    for old, new in variants[name][1]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in the "
                               "source exactly once")
        text = text.replace(old, new)
    return text


def build_variants(names, kernel: str = "k2"):
    """{name: (C function, ptxas summary)}; raises if a variant fails."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    _, _, symbol, entry, argtypes = KERNELS[kernel]
    procs = {}
    for name in names:
        cu = out_dir / f"{kernel}_{name}.cu"
        cu.write_text(variant_source(name, kernel))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{kernel}_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        own = log[log.index(symbol):]
        regs = re.search(r"Used (\d+) registers", own).group(1)
        spill = re.search(r"(\d+) bytes spill stores", own).group(1)
        fn = getattr(ctypes.CDLL(str(out_dir / f"lib{kernel}_{name}.so")), entry)
        fn.argtypes, fn.restype = argtypes, _I
        fns[name] = (fn, f"{regs} registers, {spill} B spilled")
    return fns


def _launched(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def _time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _k2_bench(gen):
    """K2: max error against the plain version at [1, 129, 2 heads] and
    [8, 1500, 12 heads] (atol 2e-3), and a timed case at [B, 1500, 12
    heads] beside SDPA."""
    def qkv(batch, t_len, n_head):
        return [(torch.randn((batch, t_len, 64 * n_head), generator=gen,
                             device="cuda") * scale).bfloat16()
                for scale in (1.0, 1.0, 0.3)]

    def call(fn, q, k, v, n_head):
        out = torch.empty_like(q)
        _launched(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     q.shape[0], q.shape[1], n_head, k2.HEAD_DIM ** -0.5,
                     torch.cuda.current_stream().cuda_stream))
        return out

    def check(name, fn):
        err = 0.0
        for shape in ((1, 129, 2), (8, 1500, 12)):
            q, k, v = qkv(*shape)
            out = call(fn, q, k, v, shape[2])
            ref = k2.encoder_attention_plain(q, k, v, shape[2])
            err = max(err, float((out.float() - ref.float()).abs().max()))
        return err, err <= 2e-3

    def timed(batch):
        q, k, v = qkv(batch, 1500, 12)
        heads = [x.view(batch, 1500, 12, 64).transpose(1, 2).contiguous()
                 for x in (q, k, v)]
        return (f"B={batch} T=1500 D=768",
                lambda name, fn: lambda: call(fn, q, k, v, 12),
                "sdpa", lambda: F.scaled_dot_product_attention(*heads))
    return check, timed


def _k1_bench(gen):
    """K1: power within rtol 2e-3 / atol 1e-6 of the plain version and the
    log-mel max error (atol 5e-4) on noise at [2, 33600] and [8, 480000],
    and a timed case at [B, 480000] beside the plain version."""
    def call(name, fn, audio):
        ops = k1.device_operands(audio.device, 80, name != "unfolded")
        out = torch.empty((audio.shape[0], audio.shape[1] // k1.HOP, 80),
                          device=audio.device)
        _launched(fn(audio.data_ptr(), audio.shape[0], audio.shape[1],
                     ops.data_ptr(), ops.numel() * 4, 80, out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream))
        return out

    def check(name, fn):
        err, ok = 0.0, True
        for shape in ((2, 33600), (8, 480000)):
            audio = torch.randn(shape, generator=gen, device="cuda") * 0.1
            power = call(name, fn, audio)
            ref = k1.mel_power_plain(audio)
            ok &= bool(((power - ref).abs() <= 1e-6 + 2e-3 * ref.abs()).all())
            err = max(err, float((melmod.log_mel_from_power(power)
                                  - melmod.log_mel_from_power(ref))
                                 .abs().max()))
        return err, ok and err <= 5e-4

    def timed(batch):
        audio = torch.randn((batch, 480000), generator=gen, device="cuda") * 0.1
        return (f"B={batch} T=480000",
                lambda name, fn: lambda: call(name, fn, audio),
                "plain", lambda: k1.mel_power_plain(audio))
    return check, timed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=list(KERNELS), default="k2")
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--variants", nargs="+",
                    help="names from VARIANTS (K2) or K1_VARIANTS (K1)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    variants = KERNELS[args.kernel][1]
    check, timed = {"k1": _k1_bench, "k2": _k2_bench}[args.kernel](gen)

    fns = build_variants(args.variants or list(variants), args.kernel)
    result = {"kernel": args.kernel, "variants": {}}
    for name, (fn, ptxas) in fns.items():
        diagnostic = variants[name][0]
        err = None
        if not diagnostic:
            err, ok = check(name, fn)
            if not ok:
                raise SystemExit(f"variant {name} disagrees: max err {err}")
        print(f"{name}: {ptxas}, diagnostic {diagnostic}, max err {err}",
              flush=True)
        result["variants"][name] = {"ptxas": ptxas, "diagnostic": diagnostic,
                                    "max_abs_err": err}
    for batch in args.batch:
        label, call, ref_name, ref = timed(batch)
        calls = {name: call(name, fn) for name, (fn, _) in fns.items()}
        calls[ref_name] = ref
        times = {name: [] for name in calls}
        for _ in range(3):
            for name, fn in calls.items():
                times[name].append(_time_ms(fn))
        for name, ts in times.items():
            print(f"{label} {name}: "
                  + ", ".join(f"{t:.4f}" for t in ts) + " ms", flush=True)
        result[f"ms_b{batch}"] = times
        del calls, ref
    result["card"] = _card()
    print(json.dumps(result))
    return 0


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
