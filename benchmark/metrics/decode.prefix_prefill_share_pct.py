"""The shared prefix's prefill share of Voxtral's decode, in %: the
``prefix_prefill`` span over the sum of the ``encoder``, ``adapter``,
``prefix_prefill`` and ``token_loop`` spans of ``ModelBundle.decode_timer``
on the traced run's synchronising pass (its spans end in a synchronize,
as ``decode.step_ms`` reads them). None where the decode has no prefix
prefill (Whisper's)."""


def read(run):
    timer = run.get("decode_timer")
    if timer is None:
        return None
    t = timer.as_dict()
    if "prefix_prefill" not in t:
        return None
    whole = sum(t.get(k, 0.0) for k in ("encoder", "adapter",
                                         "prefix_prefill", "token_loop"))
    return 100.0 * t["prefix_prefill"] / whole if whole > 0 else None
