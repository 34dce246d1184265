"""The published RE-SepFormer's operations (multiply and add counted as
two), for ``sepformer_mfu_pct``: every row of every separation call at its
own length, its encoder frames padded to a multiple of the segment size as
the model pads them (``K - T' mod K`` frames), from
``run["separation_calls"]`` and the configuration's ``resepformer``
widths. Matmuls and convolutions only: norms, softmax, masks and
activations are elementwise and left out. Rows without an encoder frame
(a batch's padding) are no work.

The peak is 494.7 TFLOP/s, the H100 SXM's dense TF32 tensor rate. The
separator runs in IEEE float32 (TF32 off), whose own peak is 66.9 TFLOP/s;
the TF32 rate is the one that any float32-accurate scheme on the tensor
cores, such as K1's 3×TF32 (three TF32 products a float32 product), stays
under, so the share stays below 100 % whichever way a later change computes
the same float32 answer.
"""

from __future__ import annotations

PEAK_FLOPS = 494.7e12


def frames(n: int, d: dict) -> int:
    """Encoder frames of a row of ``n`` samples."""
    k, st = d["kernel_size"], d["kernel_stride"]
    return (n - k) // st + 1 if n >= k else 0


def _layers(tokens: int, span: int, d: dict) -> int:
    """``num_layers`` encoder layers over ``tokens`` positions that attend
    within sequences of ``span``."""
    w, f = d["out_channels"], d["d_ffn"]
    per_token = 2 * w * 3 * w + 2 * w * w + 4 * w * f + 4 * span * w
    return d["num_layers"] * tokens * per_token


def row_flops(n: int, d: dict) -> int:
    """One row of ``n`` samples run alone."""
    tp = frames(n, d)
    if not tp:
        return 0
    N, K, L, spk = (d["N_encoder_out"], d["segment_size"], d["kernel_size"],
                    d["num_spks"])
    segs = tp // K + 1
    out = 2 * N * L * tp                                     # encoder
    out += d["layer"] * _layers(segs * K, K, d)              # segment blocks
    out += (d["layer"] - 1) * _layers(segs, segs, d)         # memory blocks
    out += 2 * tp * d["out_channels"] * spk * N              # output 1×1 conv
    out += spk * 2 * N * L * tp                              # decoder
    return out


def window_flops(calls, d: dict) -> int:
    """Every row of every call ``(rows, padded length, lengths)``."""
    return sum(row_flops(n, d) for _rows, _t, lens in calls for n in lens)
