"""The comparison that decides ``correct``, over the model families a
configuration names (its ``families``, each ``families/<name>.py``).

Each family covers some of the program's models and gives:

- ``dims(config)``, ``program_dims(engine)``: the configuration's and the
  program's widths of its models (``EngineCell`` refuses a mismatch);
- ``draw(dims, seed, device)``, ``fill(engine, weights)``: the seed's
  weights in the types they are served in, written over the program's;
- ``recorder(rng, sample)``: wrappers over the program's calls, with
  ``active``, ``fault`` (one function of the output, or a dict of them
  by model), ``kept()`` and ``remove()``; it keeps the call with the most
  rows and ``sample`` others drawn from ``rng``;
- ``readings(recorder, dims, seed, device, control)``: the kept calls
  against the family's plain reference, on the seed's weights drawn anew,
  once the program's state is freed: ``{"numbers", "control", "counts"}``
  (``control`` holds the numbers of the reference one precision below the
  configuration's in the program's place, when asked for);
- ``run_fields(recorder, dims)`` (optional): what it adds to the ``run``
  that per-layer metrics read;
- ``FAULTS``: ``{name: (model, function of the output)}``, faults planted
  where a model's answer is produced;
- ``STREAM``: the stream of ``check_rng`` its sample is drawn from.

``Check`` holds one seed's recorders for ``run.py`` and ``control.py``
alike. A name that two families give (a fault, a run field, a number) is
an error.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np


def check_rng(seed: int, stream: int) -> np.random.Generator:
    """The sample of calls kept for the check, drawn from the seed."""
    return np.random.default_rng([seed % (1 << 63), stream])


def _merge(into: dict, part: dict, what: str) -> None:
    twice = sorted(set(into) & set(part))
    if twice:
        raise ValueError(f"{what} given by two families: {twice}")
    into.update(part)


def _fault_table(families: Dict[str, object]) -> dict:
    """{fault name: (family name, model, function)} over every family."""
    table: dict = {}
    for name, fam in families.items():
        _merge(table, {f: (name, model, fn)
                       for f, (model, fn) in fam.FAULTS.items()}, "faults")
    return table


class Check:
    """The check's recorders for one seed: one a family, in the
    configuration's order, each drawing its sample from its own stream,
    with the named ``faults`` planted under the timed path."""

    def __init__(self, families: Dict[str, object], seed: int, sample: int,
                 faults: Iterable[str] = ()):
        table = _fault_table(families)
        faults = list(faults)
        unknown = [f for f in faults if f not in table]
        if unknown:
            raise KeyError(f"unknown faults {unknown}; known: {sorted(table)}")
        self.families = families
        self.recorders = {name: fam.recorder(check_rng(seed, fam.STREAM),
                                             sample)
                          for name, fam in families.items()}
        for f in faults:
            name, model, fn = table[f]
            rec = self.recorders[name]
            if isinstance(rec.fault, dict):
                rec.fault[model] = fn
            else:
                rec.fault = fn

    def set_active(self, on: bool) -> None:
        for rec in self.recorders.values():
            rec.active = on

    def remove(self) -> None:
        """Restores the program's calls, the last wrapper first."""
        for rec in reversed(list(self.recorders.values())):
            rec.remove()

    def run_fields(self, dims: Dict[str, dict]) -> dict:
        out: dict = {}
        for name, fam in self.families.items():
            if hasattr(fam, "run_fields"):
                _merge(out, fam.run_fields(self.recorders[name], dims[name]),
                       "run fields")
        return out

    def readings(self, dims: Dict[str, dict], seed: int, device,
                 control: bool = False) -> dict:
        """Every family's readings, one family at a time, so that one
        family's reference weights are freed before the next is drawn."""
        out = {"numbers": {}, "control": {}, "counts": {}}
        for name, fam in self.families.items():
            r = fam.readings(self.recorders[name], dims[name], seed, device,
                             control)
            for side in out:
                _merge(out[side], r[side], side)
        return out
