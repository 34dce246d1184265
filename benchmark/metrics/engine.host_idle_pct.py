"""The card's idle time while the host was inside the pass's own work, in %
of the profiled pass: inside the program's ``cc:process_files`` range but
outside the speaker stages' and the decode wavefront's ranges (load_gate,
make_store, plan_files, merge, the rest of prepare_files, finalize).

The program opens a ``cc:<stage>`` range for each span while the profiler
runs; they are the trace's host events. This file also holds the idle
split the two other stage readers use (``engine.speaker_idle_pct``,
``engine.decode_idle_pct``). All three take ``device.idle_pct``'s
denominator, the traced window, so the three add up to it but for the idle
time outside ``cc:process_files``."""

PROCESS = "cc:process_files"
# The stages engine.speaker_share_pct sums, with the overlap path's
# per-file sub-stages.
SPEAKER = ("cc:segmentation", "cc:diarize_cluster", "cc:profiles",
           "cc:segment_embeds", "cc:file.overlap_reseg", "cc:file.separation")
DECODE = ("cc:decode_wavefront",)


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _intersect(x, y):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        lo, hi = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if lo < hi:
            out.append([lo, hi])
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_pct(run, names=None):
    """The card's idle time inside the union of the host ranges ``names``
    (``cc:process_files`` itself when None), clipped to
    ``cc:process_files``, in % of the window; None without a device trace
    or a ``cc:process_files`` range."""
    trace = run.get("trace")
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    process = _union([(a, b) for n, a, b in trace.host if n == PROCESS])
    if not process:
        return None
    spans = process if names is None else _intersect(
        _union([(a, b) for n, a, b in trace.host if n in names]), process)
    inside = sum(b - a for a, b in spans)
    busy = sum(b - a for a, b in _intersect(spans, trace.merged))
    return 100.0 * (inside - busy) * 1e-9 / trace.window_s


def read(run):
    whole = idle_pct(run)
    if whole is None:
        return None
    return whole - idle_pct(run, SPEAKER + DECODE)
