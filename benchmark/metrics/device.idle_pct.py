"""The share of the profiled pass in which no kernel, copy or set ran on
the card, in %: 1 - busy / wall, from the device trace."""


def read(run):
    trace = run.get("trace")
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
