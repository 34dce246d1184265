"""The benchmark's own records of the program's calls, taken at the
boundaries it crosses. ``Patch`` and ``Keeper`` are what a family's
recorder (``families/<name>.py``) is built from: a wrapper over a module
attribute that the program looks up at call time, restored on
``remove``, and the sample of calls kept whole for the check.
``KernelRecorder`` records, in a traced run, the shapes of each K1 and K2
launch.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


class Patch:
    """Replaces ``module.name`` by ``make(original)`` until ``remove``."""

    def __init__(self, module, name: str, make: Callable):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        wrapped = make(self.orig)
        # A wrapper made over this one reads the call's own signature.
        wrapped.__wrapped__ = self.orig
        # The kernels count their launches on the name they are called by.
        if hasattr(self.orig, "launches"):
            wrapped.launches = self.orig.launches
        setattr(module, name, wrapped)

    def remove(self) -> None:
        setattr(self.module, self.name, self.orig)


class Keeper:
    """Keeps the record with the most rows, and ``sample`` others by
    reservoir sampling from ``rng``."""

    def __init__(self, rng: np.random.Generator, sample: int):
        self.rng, self.sample = rng, sample
        self.largest: Optional[dict] = None
        self.largest_rows = -1
        self.reservoir: List[dict] = []
        self.seen = 0

    def offer(self, rec: dict, rows: int) -> None:
        if rows > self.largest_rows:
            if self.largest is not None:
                self._sample(self.largest)
            self.largest, self.largest_rows = rec, rows
        else:
            self._sample(rec)

    def _sample(self, rec: dict) -> None:
        self.seen += 1
        if len(self.reservoir) < self.sample:
            self.reservoir.append(rec)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.sample:
            self.reservoir[j] = rec

    def kept(self) -> List[dict]:
        return ([self.largest] if self.largest else []) + list(self.reservoir)


class KernelRecorder:
    """Records the shapes of every K1 (``ops.logmel.mel_power``) and K2
    (``ops.encoder_attention.encoder_attention``) call while ``active``."""

    def __init__(self):
        from clearconverse_tpu_torch.ops import encoder_attention, logmel
        self.active = False
        self.k1: List[tuple] = []
        self.k2: List[tuple] = []

        def make_k1(orig):
            def wrapped(audio, n_mels=80):
                if self.active:
                    self.k1.append((audio.shape[0], audio.shape[-1], n_mels))
                return orig(audio, n_mels)
            return wrapped

        def make_k2(orig):
            def wrapped(q, k, v, n_head):
                if self.active:
                    self.k2.append((q.shape[0], q.shape[1], n_head,
                                    q.shape[2] // n_head))
                return orig(q, k, v, n_head)
            return wrapped

        self._patches = [Patch(logmel, "mel_power", make_k1),
                         Patch(encoder_attention, "encoder_attention", make_k2)]

    def reset(self) -> None:
        self.k1, self.k2 = [], []

    def remove(self) -> None:
        for p in self._patches:
            p.remove()
