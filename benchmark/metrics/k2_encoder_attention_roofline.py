"""K2's share of its roofline, in %: the least time of every K2 launch of
the profiled pass (``ccbench.roofline.k2_bound_s`` of its shape: the
operations at the bf16 peak, 989 TFLOP/s, or the bytes) over the pass's
``attention_bf16_kernel`` and ``attention_f32_kernel`` time in the device
trace."""

from ccbench.roofline import k2_bound_s


def read(run):
    trace, calls = run.get("trace"), run.get("k2_traced") or []
    if trace is None or not calls:
        return None
    t = (trace.kernel_seconds("attention_bf16_kernel")
         + trace.kernel_seconds("attention_f32_kernel"))
    if t <= 0:
        return None
    return 100.0 * sum(k2_bound_s(b, n, h, dh) for b, n, h, dh in calls) / t
