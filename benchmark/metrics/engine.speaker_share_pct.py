"""The speaker models' share of the window's engine passes, in %:
segmentation, diarize_cluster, profiles and segment_embeds, and the
overlap path's re-segmentation and separation where a pass has them
(``last_run_stage_times``), over the passes' walls."""

STAGES = ("segmentation", "diarize_cluster", "profiles", "segment_embeds",
          "prepare_files.overlap_reseg", "prepare_files.separation")


def read(run):
    passes = run.get("passes") or []
    wall = sum(p["wall"] for p in passes)
    if not wall:
        return None
    return 100.0 * sum(p["stages"].get(s, 0.0) for p in passes
                       for s in STAGES) / wall
