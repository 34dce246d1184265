"""Single-controller serving on a mesh.

The JAX package serves from one controller: the engine and the server run
once and every device program spans the mesh. The port keeps that shape
over ranks. Rank 0 runs ``TranscriptionEngine`` and the server unchanged;
``lead(bundle)`` makes its bundle announce each batched call (the methods
marked in ``pipeline/bundle.py``) to the world as ``(method, arguments,
config)`` before it runs. Every other rank runs ``follow(bundle)``: it
receives each call, runs the same method on its own bundle and so takes
part in the call's collectives, and returns when ``Controller.close()``
says so.

Arguments travel as host values. A device-resident ``AudioStore`` is made
on every rank by the same ``make_store`` call and travels as a key; a key
is dropped on the other ranks once rank 0's store is gone.

After each call every rank reports how it ended. When all ranks succeeded,
or all failed with the same error (the call's own, such as a bad input),
the mesh goes on and rank 0 raises that error. When they disagree, a rank
failed alone and the ranks may no longer be in step: every follower
raises, ending its process (torchrun then ends the group), and rank 0
raises and refuses every later call. A rank 0 left waiting in one of the
call's collectives by a follower that failed before it is freed by the
mesh's collective time limit (``parallel/mesh.COLLECTIVE_TIMEOUT_S``).
"""

from __future__ import annotations

import collections
import copy
import logging
import threading
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


class _StoreRef:
    """An AudioStore as it travels: the key every rank filed it under."""

    def __init__(self, key: int):
        self.key = key


def _pack(obj):
    from clearconverse_tpu_torch.pipeline.bundle import AudioStore, StoreBatch
    if isinstance(obj, AudioStore):
        return _StoreRef(obj.mesh_key)
    if isinstance(obj, StoreBatch):
        sb = copy.copy(obj)
        sb.store = _StoreRef(obj.store.mesh_key)
        return sb
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    return obj


def _unpack(obj, stores: Dict[int, Any]):
    from clearconverse_tpu_torch.pipeline.bundle import StoreBatch
    if isinstance(obj, _StoreRef):
        return stores[obj.key]
    if isinstance(obj, StoreBatch) and isinstance(obj.store, _StoreRef):
        sb = copy.copy(obj)
        sb.store = stores[obj.store.key]
        return sb
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(x, stores) for x in obj)
    if isinstance(obj, dict):
        return {k: _unpack(v, stores) for k, v in obj.items()}
    return obj


def _broadcast(msg, device: Optional[torch.device]):
    """``msg`` from rank 0 to every rank; returns it on every rank."""
    box = [msg]
    dist.broadcast_object_list(box, src=0, device=device)
    return box[0]


def _object_device(bundle) -> Optional[torch.device]:
    # NCCL moves objects through the card; gloo through the host.
    return bundle.device if dist.get_backend() == "nccl" else None


_IDLE = "<not on the mesh>"     # the status of a rank beyond the mesh


def _describe(exc: BaseException) -> str:
    return f"{type(exc).__name__}: {exc}"


def _disagreement(name: str, status: Optional[str]) -> Optional[str]:
    """Every rank's ``status`` of the call just run (None: it succeeded;
    else its error) gathered over the world. None when the ranks on the
    mesh agree, else what each of them met."""
    statuses = [None] * dist.get_world_size()
    dist.all_gather_object(statuses, status)
    ran = [s for s in statuses if s != _IDLE]
    if all(s == ran[0] for s in ran):
        return None
    return f"the ranks disagree on {name}: " + "; ".join(
        f"rank {r}: {s or 'ok'}" for r, s in enumerate(statuses)
        if s != _IDLE)


class Controller:
    """Rank 0's side. Calls are serialised: one batched call at a time is
    announced and run."""

    def __init__(self, bundle):
        self._device = _object_device(bundle)
        self._lock = threading.Lock()
        self._next_key = 0
        self._released = collections.deque()   # keys of stores gone here
        self._broken: Optional[str] = None     # why the ranks fell apart

    def call(self, bundle, fn, args, kwargs):
        with self._lock:
            if self._broken:
                raise RuntimeError(f"the mesh is down: {self._broken}")
            # The gate is probed before the call leaves this rank: once
            # announced, every rank must run it.
            bundle.check_cancel()
            key = None
            if fn.__name__ == "make_store":
                key, self._next_key = self._next_key, self._next_key + 1
            released = []
            while self._released:
                released.append(self._released.popleft())
            _broadcast((fn.__name__, _pack(args), _pack(kwargs),
                        bundle.config, bundle.torch_config, key, released),
                       self._device)
            err = None
            try:
                out = fn(bundle, *args, **kwargs)
            except Exception as exc:  # noqa: BLE001 — weighed against the followers'
                err = exc
            broken = _disagreement(fn.__name__,
                                   None if err is None else _describe(err))
            if broken:
                self._broken = broken
                raise RuntimeError(broken) from err
            if err is not None:
                raise err
            if key is not None:
                out.mesh_key = key
                weakref.finalize(out, self._released.append, key)
            return out

    def close(self) -> None:
        """End every follower's loop (they have ended already when the mesh
        is down)."""
        with self._lock:
            if not self._broken:
                _broadcast(None, self._device)


def lead(bundle) -> Controller:
    """Make rank 0's ``bundle`` the controller of the world's ranks, which
    must each be in ``follow``. Builds the bundle's mesh (a collective)."""
    if dist.get_rank() != 0:
        raise RuntimeError("only rank 0 leads")
    _ = bundle.mesh
    bundle._controller = Controller(bundle)
    return bundle._controller


def follow(bundle) -> None:
    """Run rank 0's batched calls on this rank's ``bundle`` until the
    controller closes. Builds the bundle's mesh first (a collective); a rank
    beyond the mesh receives the calls and runs none. Raises when the
    ranks disagree on how a call ended."""
    mesh = bundle.mesh
    member = mesh is None or mesh.member
    device = _object_device(bundle)
    stores: Dict[int, Any] = {}
    while True:
        msg = _broadcast(None, device)
        if msg is None:
            return
        name, args, kwargs, config, torch_config, key, released = msg
        for k in released:
            stores.pop(k, None)
        out, status = None, _IDLE
        if member:
            bundle.config, bundle.torch_config = config, torch_config
            fn = getattr(type(bundle), name).__wrapped__
            try:
                out = fn(bundle, *_unpack(args, stores),
                         **_unpack(kwargs, stores))
                status = None
            except Exception as exc:  # noqa: BLE001 — weighed against rank 0's
                logger.exception("follower: %s failed", name)
                status = _describe(exc)
        broken = _disagreement(name, status)
        if broken:
            raise RuntimeError(broken)
        if key is not None and status is None:
            stores[key] = out
