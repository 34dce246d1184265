"""The (data, model) device mesh over ``torch.distributed``.

A mesh is ``data × model`` ranks of one process group. Rank ``r`` sits at
``(r // model, r % model)``: ``model`` is innermost, as in the JAX package's
``build_mesh``. Each rank holds one subgroup along each axis: the ranks of
its data row share one model replica and split its weights (tensor
parallelism over ``model``), the ranks of its model column hold the same
shard and split the batch rows (data parallelism over ``data``).

The backend follows from where the ranks run: ``nccl`` when every rank has
a card of its own, ``gloo`` for CPU ranks and for ranks that share one card
(NCCL refuses two ranks on one GPU). Gloo reduces and broadcasts CUDA
tensors itself; an all-gather of a CUDA tensor is staged through the host.
Only NCCL's collectives can be captured in a CUDA graph, so only a mesh
with one card a rank decodes through the captured token loop
(models/decoding._graph_route).

Every collective along the mesh's axes fails after
``COLLECTIVE_TIMEOUT_S``, so a rank whose peer failed raises instead of
waiting; the default group's limit is the caller's (a serving follower
waits there for as long as the server is idle).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
# Seconds a collective waits for the other ranks before it raises.
COLLECTIVE_TIMEOUT_S = 120.0
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def local_device_count() -> int:
    """CUDA cards on this host."""
    return torch.cuda.device_count()


def backend_for(devices: Sequence) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    devs = [torch.device(d) for d in devices]
    own_cards = (all(d.type == "cuda" for d in devs)
                 and len({d.index for d in devs}) == len(devs))
    return "nccl" if own_cards else "gloo"


def init_process_group(devices: Optional[Sequence] = None,
                       init_method: str = "env://",
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       timeout_s: float = COLLECTIVE_TIMEOUT_S
                       ) -> torch.device:
    """Join the default process group and return this rank's device.

    ``devices`` names every rank's device, indexed by rank (a device may
    repeat); by default each rank runs on ``cuda:{LOCAL_RANK}``, its own
    card. ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``. The backend comes from the device list (``backend_for``);
    a failed initialisation raises."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    if devices is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= local_device_count():
            raise RuntimeError(
                f"rank {rank}: LOCAL_RANK {local} has no card of its own "
                f"({local_device_count()} on this host); pass devices=")
        device = torch.device("cuda", local)
        backend = "nccl"
    else:
        if len(devices) != world_size:
            raise ValueError(f"{len(devices)} devices for {world_size} ranks")
        device = torch.device(devices[rank])
        backend = backend_for(devices)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("rank %d of %d on %s: backend %s", rank, world_size, device,
                backend)
    return device


class Mesh:
    """This rank's place on a ``data × model`` mesh: its coordinates, its
    device, the backend, and the collectives along either axis.
    ``member`` is False on a rank beyond the mesh's ``data × model`` ranks
    (a submesh of a larger group); such a rank joins no collective."""

    def __init__(self, data: int, model: int, rank: int,
                 device: torch.device, backend: str,
                 groups: Dict[str, object]):
        self.data, self.model = data, model
        self.rank = rank
        self.device = device
        self.backend = backend
        self._groups = groups
        self.member = rank < data * model

    def __deepcopy__(self, memo):
        return self      # process groups are not copied with a module

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def all_reduce(self, t: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` in place over ``axis`` (``op``: "sum" or "max");
        returns ``t``."""
        if self.size(axis) > 1:
            dist.all_reduce(t, op=_OPS[op], group=self._groups[axis])
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0
                   ) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, concatenated along ``dim`` in
        axis order (equal shapes on every rank). The parts land in one
        output tensor, [ranks, *t.shape]: over NCCL one
        ``all_gather_into_tensor``, which a CUDA graph captures (no host
        read, no allocation that depends on the data); gloo gathers into
        views of it, a CUDA tensor staged through the host."""
        n = self.size(axis)
        if n == 1:
            return t
        group = self._groups[axis]
        staged = self.backend == "gloo" and t.device.type == "cuda"
        src = (t.cpu() if staged else t).contiguous()
        parts = src.new_empty((n, *src.shape))
        if self.backend == "gloo":
            dist.all_gather(list(parts.unbind(0)), src, group=group)
        else:
            dist.all_gather_into_tensor(parts, src, group=group)
        parts = parts.to(t.device)
        d = dim % t.dim()
        shape = list(t.shape)
        shape[d] *= n
        return parts.movedim(0, d).reshape(shape)

    def rows(self, n: int) -> slice:
        """This data rank's block of ``n`` rows (``n`` divisible by data)."""
        if n % self.data:
            raise ValueError(f"{n} rows do not split over data={self.data}")
        k = n // self.data
        return slice(self.data_index * k, (self.data_index + 1) * k)


def build_mesh(data: int = -1, model: int = 1,
               devices: Optional[Sequence] = None) -> Mesh:
    """A ``data × model`` mesh over the first ``data × model`` ranks of the
    default process group (which must exist). ``data=-1`` absorbs all
    remaining ranks. ``devices`` names every rank's device, indexed by rank;
    by default a rank runs on ``cuda:{LOCAL_RANK}``. Every rank of the group
    must call this, in the same order as its other meshes: each creates
    the subgroups of every row and column."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {data}x{model} mesh needs a process group: run the ranks "
            "under torchrun or parallel.launch.run_group")
    n = dist.get_world_size()
    rank = dist.get_rank()
    if data == -1:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data < 1 or model < 1:
        raise ValueError(f"mesh {data}x{model}: both axes must be >= 1")
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, "
                         f"have {n}")
    if devices is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    else:
        device = torch.device(devices[rank])
    groups: Dict[str, object] = {}
    limit = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    # Every rank creates every subgroup, in one order.
    rows: List[List[int]] = [[i * model + j for j in range(model)]
                             for i in range(data)]
    cols: List[List[int]] = [[i * model + j for i in range(data)]
                             for j in range(model)]
    for ranks in rows:
        g = dist.new_group(ranks, timeout=limit)
        if rank in ranks:
            groups[MODEL_AXIS] = g
    for ranks in cols:
        g = dist.new_group(ranks, timeout=limit)
        if rank in ranks:
            groups[DATA_AXIS] = g
    return Mesh(data, model, rank, device, dist.get_backend(), groups)
