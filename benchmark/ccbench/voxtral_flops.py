"""Voxtral Mini 3B's operations and the loop step's least bytes, from
shapes and the decode's counters alone (family ``voxtral``'s
``run["voxtral_calls"]`` and the traced run's ``decode_timer``).

Operations count the products a forward pass needs (two operations a
multiply-add), as a model FLOP count does: the audio tower (Whisper
large-v3's encoder, ``roofline.encoder_flops``), the adapter, the prefill
of each unique row's prompt (its vocabulary logits at the last position
only) and every loop step of every row, attention over the prefix and the
row's own suffix included. Steps past a loop's end are not counted.

A loop step's least bytes: every decoder weight and ``lm_head`` read once
in bf16 (the RMSNorm weights in f32), each unique row's prefix K/V once
(``prefix_reads``: positions read, summed over steps) and each row's
suffix K/V (``suffix_positions``), in bf16.
"""

from __future__ import annotations

from ccbench import roofline


def _t(dims: dict) -> dict:
    return dims["text_config"]


def encoder_flops(dims: dict, rows: int) -> float:
    """The audio tower over ``rows`` 30 s windows."""
    a = dims["audio_config"]
    return roofline.encoder_flops(
        {"d_model": a["hidden_size"], "encoder_ffn_dim": a["intermediate_size"],
         "num_mel_bins": a["num_mel_bins"],
         "max_source_positions": a["max_source_positions"],
         "encoder_layers": a["num_hidden_layers"]}, rows)


def adapter_flops(dims: dict, rows: int) -> float:
    """linear_1 and linear_2 over each window's 375 rows of 4 frames."""
    a, d = dims["audio_config"], _t(dims)["hidden_size"]
    n = a["max_source_positions"] * a["hidden_size"] // a["intermediate_size"]
    return rows * n * 2 * (a["intermediate_size"] * d + d * d)


def _widths(dims: dict):
    t = _t(dims)
    q = t["num_attention_heads"] * t["head_dim"]
    kv = t["num_key_value_heads"] * t["head_dim"]
    return t["hidden_size"], q, kv, t["intermediate_size"], t["vocab_size"]


def layer_flops(dims: dict) -> float:
    """One token through one layer's projections and MLP."""
    d, q, kv, f, _ = _widths(dims)
    return 2 * (d * q + 2 * d * kv + q * d + 3 * d * f)


def attention_flops(dims: dict) -> float:
    """One token's QK and PV products for each position it attends to,
    over every layer."""
    t = _t(dims)
    return 4 * t["num_attention_heads"] * t["head_dim"] * t["num_hidden_layers"]


def logits_flops(dims: dict) -> float:
    d, _, _, _, v = _widths(dims)
    return 2 * d * v


def call_flops(dims: dict, c: dict) -> float:
    """A decode call's decoder work from its counters: the prefill of every
    unique row's prompt (position j attends to j + 1 positions) and
    ``steps`` loop steps of every row (step j attends to the prompt and j
    suffix positions)."""
    n_layer = _t(dims)["num_hidden_layers"]
    U, rows, steps = c["prefix_rows"], c["rows"], c["steps"]
    P = c["prefix_positions"] // max(U, 1)
    per_tok = n_layer * layer_flops(dims)
    att = attention_flops(dims)
    prefill = U * (P * per_tok + att * P * (P + 1) / 2 + logits_flops(dims))
    loop = rows * steps * (per_tok + logits_flops(dims) + att * P) \
        + att * c["suffix_positions"]
    return prefill + loop


def weight_bytes(dims: dict) -> float:
    """The decoder's weights and ``lm_head`` as a step reads them: bf16
    matrices, f32 RMSNorm weights."""
    t = _t(dims)
    d, q, kv, f, v = _widths(dims)
    per_layer = 2 * (d * q + 2 * d * kv + q * d + 3 * d * f) + 4 * 2 * d
    return t["num_hidden_layers"] * per_layer + 2 * d * v + 4 * d


def kv_bytes_per_position(dims: dict) -> float:
    """K and V of one position over every layer, bf16."""
    t = _t(dims)
    return 2 * t["num_hidden_layers"] * t["num_key_value_heads"] \
        * t["head_dim"] * 2


def loop_least_s(dims: dict, steps: int, prefix_reads: int,
                 suffix_positions: int) -> float:
    """The least time of ``steps`` loop steps at 3.35 TB/s."""
    moved = (steps * weight_bytes(dims)
             + (prefix_reads + suffix_positions) * kv_bytes_per_position(dims))
    return moved / roofline.HBM_BYTES_PER_S
