"""The published RE-SepFormer's operations in the window, every row at its
own length (``ccbench.sepformer_flops``, from the separation calls family
``resepformer`` recorded), over 494.7 TFLOP/s (dense TF32; the reason is in
that module) times the window, in %."""

from ccbench import sepformer_flops


def read(run):
    win, calls = run.get("window"), run.get("separation_calls")
    dims = run.get("resepformer_dims")
    if win is None or not win["window_s"] or not calls or dims is None:
        return None
    return 100.0 * sepformer_flops.window_flops(calls, dims) / (
        sepformer_flops.PEAK_FLOPS * win["window_s"])
