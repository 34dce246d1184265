"""The card's idle time while the host was inside the decode wavefront's
range (``cc:decode_wavefront``), in % of the profiled pass. The split:
``engine.host_idle_pct.py``."""

import os
import runpy

_SPLIT = runpy.run_path(os.path.join(os.path.dirname(__file__),
                                     "engine.host_idle_pct.py"))


def read(run):
    return _SPLIT["idle_pct"](run, _SPLIT["DECODE"])
