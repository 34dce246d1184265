"""Voxtral's loop step against its roofline, in %: the least time of the
traced run's synchronising pass's loop steps (``ccbench.voxtral_flops.
loop_least_s``: decoder weights and ``lm_head`` once a step in bf16, each
unique row's prefix K/V once a step, each row's suffix K/V, at 3.35 TB/s;
from the decode timer's counters ``token_loop_steps``, ``prefix_reads`` and
``suffix_positions``) over the ``token_loop`` span, the time
``decode.step_ms`` reads."""

from ccbench import voxtral_flops


def read(run):
    timer, dims = run.get("decode_timer"), run.get("voxtral_dims")
    if timer is None or dims is None:
        return None
    c = timer.counts
    steps = c.get("token_loop_steps", 0)
    if not steps or "prefix_reads" not in c:
        return None
    t = timer.as_dict().get("token_loop", 0.0)
    if t <= 0:
        return None
    return 100.0 * voxtral_flops.loop_least_s(
        dims, steps, c["prefix_reads"], c["suffix_positions"]) / t
