"""The decode wavefront's share of the window's engine passes, in %: its
seconds (``last_run_stage_times["decode_wavefront"]``, a span the engine
records on every pass) over the passes' walls."""


def read(run):
    passes = run.get("passes") or []
    wall = sum(p["wall"] for p in passes)
    if not wall:
        return None
    return 100.0 * sum(p["stages"].get("decode_wavefront", 0.0)
                       for p in passes) / wall
