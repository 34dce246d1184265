"""Megatron tensor parallelism of Whisper over the mesh's ``model`` axis.

The JAX package's sharding rules in PyTorch's layouts: q/k/v and fc1 are
column-sharded (each rank holds a block of output features: heads or
hidden units), out and fc2 row-sharded (a block of input features), so each
attention and each MLP needs one sum over the model axis. ``nn.Linear``
stores ``[out, in]``, so a column shard slices weight dim 0 and its bias, a
row shard weight dim 1; a row-sharded layer's bias stays whole and is added
once, after the sum. Layer norms, ``tok``, ``pos`` and the convolutions are
replicated. The batch splits over ``data``.

Megatron's two collectives are autograd Functions: ``_Enter`` (identity
forward, sum over the model axis backward) before the column-sharded
layers, ``_Reduce`` (sum forward, identity backward) after the row-sharded
ones. Where the head count does not divide by ``model``, the column shards
of q, k and v are gathered into whole heads before the attention
(``_Gather``, whose backward sums and keeps this rank's block) and each rank
multiplies its own block of the attention's output by its row shard.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch
from torch import nn

from clearconverse_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh

_COLUMN = ("attn.q", "attn.k", "attn.v", "cross.q", "cross.k", "cross.v",
           "mlp.fc1")
_ROW = ("attn.out", "cross.out", "mlp.fc2")


def _kind(module_name: str) -> Optional[str]:
    if module_name.endswith(_COLUMN):
        return "column"
    if module_name.endswith(_ROW):
        return "row"
    return None


def param_split(name: str) -> Optional[int]:
    """The dim along which parameter or buffer ``name`` of a Whisper is
    split over ``model``: 0 for a column-sharded layer's weight, bias and
    int8 codes and scales, 1 for a row-sharded layer's weight or codes,
    None for what is replicated (a row-sharded layer's bias and scales)."""
    module, _, leaf = name.rpartition(".")
    kind = _kind(module)
    if kind == "column":
        return 0
    if kind == "row" and leaf in ("weight", "wq"):
        return 1
    return None


def whisper_param_spec(model: nn.Module) -> Dict[str, Optional[int]]:
    """``param_split`` for every parameter and buffer of ``model``."""
    names = [n for n, _ in model.named_parameters()] + \
        [n for n, _ in model.named_buffers()]
    return {n: param_split(n) for n in names}


def batch_spec(x, mesh: Optional[Mesh]):
    """This data rank's block of the rows of a global batch (the JAX
    package's ``P("data", None, ...)``)."""
    return x if mesh is None else x[mesh.rows(len(x))]


def replicated_spec(x):
    """Every rank holds all of ``x`` (the JAX package's ``P()``)."""
    return x


# ------------------------------------------------------------ collectives

class _Enter(torch.autograd.Function):
    """Megatron's f: identity forward, sum over the model axis backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), MODEL_AXIS), None


class _Reduce(torch.autograd.Function):
    """Megatron's g: sum over the model axis forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.clone(), MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Column shards → whole features along the last dim; backward sums the
    gradient over the model axis and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return mesh.all_gather(x.contiguous(), MODEL_AXIS, dim=-1)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_reduce(g.contiguous().clone(), MODEL_AXIS)
        j, w = ctx.mesh.model_index, ctx.width
        return g[..., j * w:(j + 1) * w], None


class TensorParallel:
    """The context a sharded Whisper carries (``model.tp``): the mesh, the
    local head counts and Megatron's collectives."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.size = mesh.model
        self.index = mesh.model_index

    def __deepcopy__(self, memo):
        return self

    def splits(self, n_head: int) -> bool:
        """Whether ``n_head`` heads split whole over the model axis."""
        return n_head % self.size == 0

    def heads(self, n_head: int) -> int:
        """Heads this rank attends with: its share, or all of them when
        they do not split (q, k, v gathered)."""
        return n_head // self.size if self.splits(n_head) else n_head

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.mesh)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.mesh)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(x, self.mesh)

    def local_columns(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the last dim of a whole-feature tensor."""
        w = x.shape[-1] // self.size
        return x[..., self.index * w:(self.index + 1) * w]

    def grad_norm(self, model: nn.Module) -> torch.Tensor:
        """The global L2 norm of the whole model's gradients: squares of
        the shards summed over the model axis, replicated gradients (whole
        and equal on every rank) counted once."""
        split, whole = [], []
        for name, p in model.named_parameters():
            if p.grad is not None:
                sq = p.grad.float().square().sum()
                (whole if param_split(name) is None else split).append(sq)
        dev = next(model.parameters()).device
        s = torch.stack(split).sum() if split else torch.zeros((), device=dev)
        w = torch.stack(whole).sum() if whole else torch.zeros((), device=dev)
        return (self.mesh.all_reduce(s, MODEL_AXIS) + w).sqrt()


# ----------------------------------------------------------- weights

def _slice(t: torch.Tensor, dim: int, size: int, index: int) -> torch.Tensor:
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over "
                         f"model={size}")
    w = t.shape[dim] // size
    return t.narrow(dim, index * w, w).clone()


def _replace(mod: nn.Module, leaf: str, t: torch.Tensor) -> None:
    old = getattr(mod, leaf)
    if isinstance(old, nn.Parameter):
        setattr(mod, leaf, nn.Parameter(t, requires_grad=old.requires_grad))
    else:
        setattr(mod, leaf, t)


def _share_all(model: nn.Module) -> Dict[int, Any]:
    """A deepcopy memo that keeps every parameter and buffer shared."""
    memo: Dict[int, Any] = {id(p): p for p in model.parameters()}
    memo.update({id(b): b for b in model.buffers()})
    return memo


def _resize(mod: nn.Module) -> None:
    if isinstance(mod, nn.Linear):
        mod.out_features, mod.in_features = mod.weight.shape


@torch.no_grad()
def shard_whisper(model: nn.Module, mesh: Mesh) -> nn.Module:
    """This rank's tensor-parallel shard of a whole ``Whisper`` (plain or
    with an int8 decoder): a new module whose column- and row-sharded
    layers hold this rank's blocks and which carries ``tp``; replicated
    parameters stay shared with ``model``. With ``model=1`` it is
    ``model`` itself. The widths must divide by ``model``."""
    if mesh.model == 1:
        return model
    out = copy.deepcopy(model, _share_all(model))
    for name, mod in out.named_modules():
        if _kind(name) is None:
            continue
        for leaf, t in list(mod.named_parameters(recurse=False)) + \
                list(mod.named_buffers(recurse=False)):
            dim = param_split(f"{name}.{leaf}")
            if dim is not None:
                _replace(mod, leaf, _slice(t, dim, mesh.model,
                                           mesh.model_index))
        _resize(mod)
    out.tp = TensorParallel(mesh)
    return out


def gather_split(name: str, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of a shard ``t`` of parameter ``name`` (itself when
    ``name`` is replicated). A collective over the model axis."""
    dim = param_split(name)
    if dim is None or mesh.model == 1:
        return t
    return mesh.all_gather(t.detach().contiguous(), MODEL_AXIS, dim=dim)


@torch.no_grad()
def unshard_whisper(shard: nn.Module, mesh: Mesh) -> nn.Module:
    """The whole ``Whisper`` of a ``shard_whisper`` shard on every rank of
    its model axis (a collective), without ``tp``."""
    if getattr(shard, "tp", None) is None:
        return shard
    out = copy.deepcopy(shard, _share_all(shard))
    del out.tp
    for name, mod in out.named_modules():
        if _kind(name) is None:
            continue
        for leaf, t in list(mod.named_parameters(recurse=False)) + \
                list(mod.named_buffers(recurse=False)):
            whole = gather_split(f"{name}.{leaf}", t, mesh)
            if whole is not t:
                _replace(mod, leaf, whole)
        _resize(mod)
    return out

