"""The token loop's time per step, in ms: the ``token_loop`` span over
the ``token_loop_steps`` count of ``ModelBundle.decode_timer`` on the
traced run's synchronising pass (its spans end in a synchronize, so they
are read there and not in the window)."""


def read(run):
    timer = run.get("decode_timer")
    if timer is None:
        return None
    steps = timer.counts.get("token_loop_steps", 0)
    if not steps:
        return None
    return timer.as_dict().get("token_loop", 0.0) / steps * 1e3
