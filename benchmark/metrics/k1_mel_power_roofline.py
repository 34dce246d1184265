"""K1's share of its roofline, in %: the least time of every K1 launch of
the profiled pass (``ccbench.roofline.k1_bound_s`` of its shape: bytes at
3.35 TB/s or operations at the f32 peak) over the pass's
``mel_power_kernel`` time in the device trace."""

from ccbench.roofline import k1_bound_s


def read(run):
    trace, calls = run.get("trace"), run.get("k1_traced") or []
    if trace is None or not calls:
        return None
    t = trace.kernel_seconds("mel_power_kernel")
    if t <= 0:
        return None
    return 100.0 * sum(k1_bound_s(b, n, m) for b, n, m in calls) / t
