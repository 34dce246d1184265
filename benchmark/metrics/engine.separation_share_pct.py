"""The separation stage's share of the window's engine passes, in %: its
seconds (``last_run_stage_times["prepare_files.separation"]``, every
overlap span of the pass separated in batches) over the passes' walls."""


def read(run):
    passes = run.get("passes") or []
    wall = sum(p["wall"] for p in passes)
    if not wall:
        return None
    return 100.0 * sum(p["stages"].get("prepare_files.separation", 0.0)
                       for p in passes) / wall
