"""Whisper's operations in the window over the bf16 peak (989 TFLOP/s)
times the window, in %: the encoder for every row K1 turned into log-mel
(decode and word timestamps), and for every decode call the cross-KV of
its unique rows, the prefill of its real prompt tokens and the loop steps
it ran over all its rows (``ccbench.roofline``). The word-timestamp
pass's teacher-forced decoder is not counted."""

from ccbench import roofline


def read(run):
    win, dims = run.get("window"), run["dims"]
    k1, calls = run.get("k1_window"), run.get("decode_calls")
    if win is None or not win["window_s"] or k1 is None or not calls:
        return None
    flops = sum(roofline.encoder_flops(dims, b) for b, _n, _m in k1)
    for rows, prompt_lens, steps in calls:
        flops += roofline.cross_kv_flops(dims, rows)
        flops += roofline.decode_call_flops(dims, prompt_lens, steps)
    return 100.0 * flops / (roofline.PEAK_FLOPS["bfloat16"] * win["window_s"])
