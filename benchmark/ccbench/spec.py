"""Finds a cell's parts by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<config>.json``), the model families the
configuration names (``families/<family>.py``), its traffic mix
(``traffic/<traffic>.json``), the code of the mix's kind
(``kinds/<kind>.py``), its limits (``limits/<cell>.json``) and the reader
of each per-layer metric (``metrics/<metric>.py``). A later change adds a
part as a file and an entry; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(*parts: str) -> dict:
    with open(os.path.join(*parts), encoding="utf-8") as fh:
        return json.load(fh)


class Cell:
    def __init__(self, name: str, bench_dir: str = BENCH_DIR,
                 root: str = ROOT):
        self.bench_dir, self.root = bench_dir, root
        self.manifest = _json(root, "BENCHMARK.json")
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config = _json(bench_dir, "configs", self.entry["config"] + ".json")
        self.traffic = _json(bench_dir, "traffic", self.entry["traffic"] + ".json")
        self.limits = _json(bench_dir, "limits", name + ".json")

    def _in_cell(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self) -> list:
        return [m for m in self.manifest["end_to_end"] if self._in_cell(m)]

    def per_layer(self) -> list:
        return [m for m in self.manifest["per_layer"] if self._in_cell(m)]

    def _module(self, folder: str, name: str):
        path = os.path.join(self.bench_dir, folder, name + ".py")
        spec = importlib.util.spec_from_file_location(
            f"ccbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str) -> Callable:
        """``read(run)`` of ``metrics/<metric>.py``."""
        return self._module("metrics", metric).read

    def kind(self):
        """The module of the mix's kind, ``kinds/<kind>.py``: ``generate``,
        ``warm``, ``window`` and ``unit``."""
        return self._module("kinds", self.traffic["kind"])

    def families(self) -> Dict[str, object]:
        """{name: module of ``families/<name>.py``} for each family the
        configuration names, in its order (``ccbench/check.py`` says what a
        family gives)."""
        names = self.config["families"]
        if not names or len(set(names)) != len(names):
            raise ValueError(f"configuration {self.entry['config']!r}: "
                             f"families {names} must be named once each")
        return {n: self._module("families", n) for n in names}


def readers(cell: Cell) -> Dict[str, Callable]:
    return {m["name"]: cell.reader(m["name"]) for m in cell.per_layer()}
