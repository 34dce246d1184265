"""Decode graphs captured inside the window (``decode_graph.COUNTS``): a
shape the warm-up missed, whose capture the window then paid for."""


def read(run):
    win = run.get("window")
    return None if win is None else float(win["captures_in_window"])
