"""Voxtral's operations in the window over the bf16 peak (989 TFLOP/s)
times the window, in %: the audio tower for every row K1 turned into
log-mel, and for every decode call of the window (family ``voxtral``'s
``run["voxtral_calls"]``, the program's counters) the adapter of its unique
rows, the prefill of their prompts and every loop step of every row,
attention over the prefix and the row's suffix included
(``ccbench.voxtral_flops``)."""

from ccbench import roofline, voxtral_flops


def read(run):
    win, dims = run.get("window"), run.get("voxtral_dims")
    k1, calls = run.get("k1_window"), run.get("voxtral_calls")
    if win is None or not win["window_s"] or dims is None or k1 is None \
            or not calls:
        return None
    flops = sum(voxtral_flops.encoder_flops(dims, b) for b, _n, _m in k1)
    for c in calls:
        flops += (voxtral_flops.adapter_flops(dims, c["prefix_rows"])
                  + voxtral_flops.call_flops(dims, c))
    return 100.0 * flops / (roofline.PEAK_FLOPS["bfloat16"] * win["window_s"])
