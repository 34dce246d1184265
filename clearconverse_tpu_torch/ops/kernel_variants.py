"""Time text variants of K2's bf16 kernel against the kernel as built and SDPA.

Each variant is ``csrc/encoder_attention.cu`` with a few source lines
replaced. All are built at once with ``build.NVCC_FLAGS`` into
``_build/variants/`` and called through the same C entry point as the
kernel. Variants marked diagnostic take work away (the exponentials, the
softmax, the refills of the ring) and give wrong outputs: they time
what is left. The others are checked against the plain version (atol 2e-3)
before they are timed. Needs a CUDA card; from the repository root:

    python3 -m clearconverse_tpu_torch.ops.kernel_variants [--batch 8 32]

Prints ptxas's registers and spills per variant, each variant's error, the
times (ms, three rounds in turn with SDPA) and, last, one JSON line that
also holds the card's name and power limit.
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

from clearconverse_tpu_torch.ops import build
from clearconverse_tpu_torch.ops import encoder_attention as k2

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


def variant_source(name: str) -> str:
    """K2's source with variant ``name``'s lines replaced; raises if a line
    to replace is not in the source exactly once."""
    text = (build.CSRC / "encoder_attention.cu").read_text()
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in the "
                               "source exactly once")
        text = text.replace(old, new)
    return text


def build_variants(names):
    """{name: (C function, ptxas summary)}; raises if a variant fails."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for name in names:
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(name))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        bf16 = log[log.index("attention_bf16_kernel"):]
        regs = re.search(r"Used (\d+) registers", bf16).group(1)
        spill = re.search(r"(\d+) bytes spill stores", bf16).group(1)
        fn = ctypes.CDLL(str(out_dir / f"lib{name}.so")).cc_encoder_attention_bf16
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, ctypes.c_float, p]
        fn.restype = i
        fns[name] = (fn, f"{regs} registers, {spill} B spilled")
    return fns


def _call(fn, q, k, v, n_head):
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.shape[0], q.shape[1], n_head, k2.HEAD_DIM ** -0.5,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return out


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA card", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(batch, t_len, n_head):
        return [(torch.randn((batch, t_len, 64 * n_head), generator=gen,
                             device="cuda") * scale).bfloat16()
                for scale in (1.0, 1.0, 0.3)]

    fns = build_variants(args.variants)
    result = {"variants": {}}
    for name, (fn, ptxas) in fns.items():
        diagnostic = VARIANTS[name][0]
        err = None
        if not diagnostic:
            err = 0.0
            for shape in ((1, 129, 2), (8, 1500, 12)):
                q, k, v = qkv(*shape)
                out = _call(fn, q, k, v, shape[2])
                ref = k2.encoder_attention_plain(q, k, v, shape[2])
                err = max(err, float((out.float() - ref.float()).abs().max()))
            if not err <= 2e-3:
                raise SystemExit(f"variant {name} disagrees: max err {err}")
        print(f"{name}: {ptxas}, diagnostic {diagnostic}, max err {err}",
              flush=True)
        result["variants"][name] = {"ptxas": ptxas, "diagnostic": diagnostic,
                                    "max_abs_err": err}
    for batch in args.batch:
        q, k, v = qkv(batch, 1500, 12)
        heads = [x.view(batch, 1500, 12, 64).transpose(1, 2).contiguous()
                 for x in (q, k, v)]
        times = {name: [] for name in fns}
        times["sdpa"] = []
        for _ in range(3):
            for name, (fn, _) in fns.items():
                times[name].append(_time_ms(lambda: _call(fn, q, k, v, 12)))
            times["sdpa"].append(_time_ms(
                lambda: F.scaled_dot_product_attention(*heads)))
        for name, ts in times.items():
            print(f"B={batch} T=1500 D=768 {name}: "
                  + ", ".join(f"{t:.4f}" for t in ts) + " ms", flush=True)
        result[f"ms_b{batch}"] = times
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
