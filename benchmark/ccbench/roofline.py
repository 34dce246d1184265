"""The chip's peaks and the work of each measured kernel and of Whisper,
from shapes alone.

K1 and K2's bounds copy ``chip_smoke.py`` phase 2's arithmetic, taken to
any ``n_mels`` and head count. Whisper's operations count the products
that a forward pass needs at the call's shapes (two operations a
multiply-add), as a model FLOP count does: padding slots and steps past a
loop's end are not counted.
"""

from __future__ import annotations

import math

from ccbench.reference import mel_filters

# NVIDIA H100 SXM, published dense peaks at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}

N_FFT = 400
HOP = 160


def bound_s(bytes_moved: float, flops: float, dtype: str) -> float:
    """The least time the chip could take: bytes or operations."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def k1_work(rows: int, samples: int, n_mels: int):
    """(bytes, operations) of K1 over [rows, samples] f32 audio: the audio
    read, the mel power written and the DFT and filterbank read once; per
    frame the window, a real 400-point FFT (2.5 N log2 N), the power and
    the filterbank's nonzeros."""
    frames = samples // HOP
    nnz = int((mel_filters(n_mels) != 0).sum())
    frame_flops = N_FFT + 2.5 * N_FFT * math.log2(N_FFT) + 3 * 201 + 2 * nnz
    moved = 4 * (rows * samples + rows * frames * n_mels
                 + 2 * N_FFT * 201 + 201 * n_mels)
    return moved, rows * frames * frame_flops


def k1_bound_s(rows: int, samples: int, n_mels: int) -> float:
    return bound_s(*k1_work(rows, samples, n_mels), "float32")


def k2_work(rows: int, t: int, heads: int, head_dim: int = 64):
    """(bytes, operations) of K2 in bf16: q, k, v read and the output
    written once; QK^T and PV at 2 operations a multiply-add."""
    return (4 * rows * t * heads * head_dim * 2,
            4 * rows * heads * t * t * head_dim)


def k2_bound_s(rows: int, t: int, heads: int, head_dim: int = 64) -> float:
    return bound_s(*k2_work(rows, t, heads, head_dim), "bfloat16")


def encoder_flops(dims: dict, rows: int) -> float:
    """One encoder pass over ``rows`` 30 s windows (3000 mel frames)."""
    d, f, m = dims["d_model"], dims["encoder_ffn_dim"], dims["num_mel_bins"]
    t = dims["max_source_positions"]
    conv = 2 * 3 * m * d * (2 * t) + 2 * 3 * d * d * t
    layer = 2 * t * (4 * d * d + 2 * d * f) + 4 * t * t * d
    return rows * (conv + dims["encoder_layers"] * layer)


def cross_kv_flops(dims: dict, rows: int) -> float:
    d, t = dims["d_model"], dims["max_source_positions"]
    return rows * dims["decoder_layers"] * 2 * t * 2 * d * d


def decoder_token_flops(dims: dict, context: int) -> float:
    """One decoder token that attends to ``context`` earlier tokens
    (itself included) and the audio, and its vocabulary logits."""
    d, f, t = dims["d_model"], dims["decoder_ffn_dim"], dims["max_source_positions"]
    layer = 2 * (6 * d * d + 2 * d * f) + 4 * d * context + 4 * d * t
    return dims["decoder_layers"] * layer + 2 * d * dims["vocab_size"]


def decode_call_flops(dims: dict, prompt_lens, steps: int) -> float:
    """The prefill of each row's real prompt (its left padding is not
    counted) and ``steps`` loop steps of every row: token j of a row, from
    the first prompt token on, attends to j + 1 tokens."""
    per_ctx = 4 * dims["d_model"] * dims["decoder_layers"]
    fixed = decoder_token_flops(dims, 0)
    total = 0.0
    for p in prompt_lens:
        n = int(p) + steps
        total += n * fixed + per_ctx * n * (n + 1) / 2
    return total
