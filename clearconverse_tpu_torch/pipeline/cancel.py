"""Cooperative cancellation shared by the engine and the bundle.

A running device program cannot be killed in-process, so the engine and
every batched bundle method check a caller-supplied ``should_cancel()`` at
batch boundaries: cancel latency is one device batch. This module stays
free of torch so a task layer can import the exception cheaply.
"""

from __future__ import annotations

from typing import Callable, Optional


class ProcessingCancelled(Exception):
    """Raised inside engine phases when should_cancel() reports True."""


def check_cancel(should_cancel: Optional[Callable[[], bool]]) -> None:
    if should_cancel is not None and should_cancel():
        raise ProcessingCancelled()
