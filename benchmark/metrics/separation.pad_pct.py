"""The share of the samples the separator ran that were padding, in %:
duration-bucket padding of each overlap span and the rows of the bundle's
row bucket, over the separation calls of the window (family
``resepformer``'s ``run["separation_calls"]``)."""


def read(run):
    calls = run.get("separation_calls")
    if not calls:
        return None
    ran = sum(rows * t for rows, t, _lens in calls)
    real = sum(sum(lens) for _rows, _t, lens in calls)
    return 100.0 * (ran - real) / ran if ran else None
