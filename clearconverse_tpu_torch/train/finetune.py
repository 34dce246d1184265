"""Whisper fine-tuning: teacher-forced cross-entropy and an AdamW step.

The port of the JAX package's train/finetune.py, under the same names. The
step mutates the model and its optimizer in place and returns its metrics
as device tensors (no host read inside the step). The loss runs the
inference forward passes (``whisper_encode`` with kernel K2 on CUDA, whose
backward recomputes through the plain attention; ``precompute_cross_kv``;
one ``decoder_forward`` over the whole target sequence), so what is trained
is what is served. On a (data, model) mesh the step trains this rank's
tensor-parallel shard on its data rank's rows of the global batch.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from clearconverse_tpu_torch.models.whisper import (
    Whisper, WhisperDims, decoder_forward, init_kv_cache, precompute_cross_kv,
    tensor_parallel, whisper_encode)

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    model: Whisper
    optimizer: torch.optim.Optimizer
    step: int = 0


def trainable_whisper(model: Whisper) -> Whisper:
    """An f32 copy of ``model`` whose parameters require grad (the loaders
    build inference-only modules: grads off, matmul weights in the compute
    dtype)."""
    return copy.deepcopy(model).float().requires_grad_(True).train()


def whisper_loss_sums(model: Whisper, batch: Batch, dims: WhisperDims,
                      compute_dtype: torch.dtype = torch.bfloat16,
                      remat: bool = False
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Teacher-forced CE in unnormalised form: (sum_nll, (n_tokens,
    n_correct)). The sums compose exactly across microbatches: the global
    mean loss is Σsum_nll/Σn_tokens and its gradient Σgrad(sum_nll)/
    Σn_tokens. batch: mel [B, M, T], tokens [B, L] (decoder input, starting
    with the SOT sequence), targets [B, L], loss_mask [B, L] float.

    ``remat=True`` wraps the whole forward in a non-reentrant
    ``torch.utils.checkpoint``: activations are recomputed in the backward
    pass instead of stored, as ``jax.checkpoint`` does."""
    mel, tokens = batch["mel"], batch["tokens"].long()
    targets, mask = batch["targets"].long(), batch["loss_mask"].float()
    B, L = tokens.shape
    dev = tokens.device

    def forward(mel, tokens):
        audio = whisper_encode(model, mel, dims, compute_dtype)
        cross_kv = precompute_cross_kv(model, audio, dims.n_text_head, bits=16)
        self_kv = init_kv_cache(dims, B, L, compute_dtype, device=dev,
                                tp=tensor_parallel(model))
        pos = torch.arange(L, device=dev)[None, :].expand(B, L)
        k = torch.arange(L, device=dev)[None, None, None, :]
        q = torch.arange(L, device=dev)[None, None, :, None]
        causal = torch.where(k <= q, 0.0, -1e9).float()
        logits, _ = decoder_forward(model, tokens, pos, 0, self_kv, cross_kv,
                                    causal, None, dims, compute_dtype)
        return logits

    if remat:
        logits = checkpoint(forward, mel, tokens, use_reentrant=False)
    else:
        logits = forward(mel, tokens)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    sum_nll = (nll * mask).sum()
    n_tok = mask.sum()
    n_correct = ((logits.argmax(-1) == targets).float() * mask).sum()
    return sum_nll, (n_tok, n_correct)


def whisper_loss(model: Whisper, batch: Batch, dims: WhisperDims,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False) -> Tuple[torch.Tensor, Dict]:
    """Teacher-forced mean CE over the masked tokens, and its metrics."""
    sum_nll, (n_tok, n_correct) = whisper_loss_sums(model, batch, dims,
                                                    compute_dtype, remat)
    denom = n_tok.clamp(min=1.0)
    loss = sum_nll / denom
    return loss, {"loss": loss, "accuracy": n_correct / denom}


class ClippedAdamW(torch.optim.AdamW):
    """AdamW after a clip by global norm, written to optax's
    ``clip_by_global_norm`` rule: when the norm of all gradients reaches
    ``clip``, every gradient becomes g / norm * clip (no epsilon). The clip
    runs on the device, without reading the norm back. ``norm`` passes the
    global norm in when the parameters are shards of a larger model (the
    mesh step takes it over the model axis)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], clip: float,
                 **kwargs):
        super().__init__(params, **kwargs)
        self.clip = float(clip)

    @torch.no_grad()
    def step(self, closure=None, norm: Optional[torch.Tensor] = None):
        grads = [p.grad for group in self.param_groups
                 for p in group["params"] if p.grad is not None]
        if grads:
            if norm is None:
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(g.float()) for g in grads]))
            keep = norm < self.clip
            div = torch.where(keep, torch.ones_like(norm), norm)
            mul = torch.where(keep, torch.ones_like(norm),
                              torch.full_like(norm, self.clip))
            for g in grads:
                g.div_(div).mul_(mul)
        return super().step(closure)


def default_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-5,
                      weight_decay: float = 0.01,
                      clip: float = 1.0) -> ClippedAdamW:
    """optax.chain(clip_by_global_norm(clip), adamw(lr, weight_decay)):
    optax's AdamW defaults (b1 0.9, b2 0.999, eps 1e-8) and decay on every
    parameter."""
    return ClippedAdamW(params, clip, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                        weight_decay=weight_decay)


def init_train_state(model: Whisper,
                     optimizer: Optional[torch.optim.Optimizer] = None
                     ) -> TrainState:
    """The state a step updates: a trainable ``model`` (see
    ``trainable_whisper``) and its optimizer (``default_optimizer`` over
    the model's parameters when none is given)."""
    optimizer = optimizer or default_optimizer(model.parameters())
    return TrainState(model=model, optimizer=optimizer)


def make_train_step(dims: WhisperDims, mesh=None,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    remat: bool = False,
                    accum_steps: int = 1
                    ) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """``step(state, batch) -> {"loss", "accuracy"}``: one optimizer update
    of ``state`` in place.

    The batch splits into ``accum_steps`` microbatches (the leading axis
    must divide evenly); each one's unnormalised ``sum_nll`` is
    backpropagated, and the summed gradients divide by the global token
    count before the clip, which equals the full-batch gradient at
    1/accum_steps of the activation memory. ``remat`` recomputes forward
    activations in the backward pass.

    With a ``mesh`` (``parallel/``), ``state.model`` is this rank's
    ``shard_whisper`` shard and ``batch`` the global batch: each microbatch
    splits its rows over the data axis, the gradients, loss sums and token
    counts are summed over the data axis before the division, and the clip
    takes the global norm of the whole model over the model axis, so the
    update equals the 1×1 step's."""
    from clearconverse_tpu_torch.parallel.mesh import DATA_AXIS
    from clearconverse_tpu_torch.parallel.sharding import batch_spec
    d = 1 if mesh is None else mesh.data

    def step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        b = batch["tokens"].shape[0]
        if b % (accum_steps * d):
            raise ValueError(f"batch {b} not divisible by "
                             f"accum_steps={accum_steps} x data={d}")
        mb = b // accum_steps
        state.optimizer.zero_grad(set_to_none=True)
        s = n = c = None
        for i in range(accum_steps):
            micro = {k: batch_spec(v[i * mb:(i + 1) * mb], mesh)
                     for k, v in batch.items()}
            sum_nll, (n_tok, n_correct) = whisper_loss_sums(
                state.model, micro, dims, compute_dtype, remat)
            sum_nll.backward()
            s = sum_nll.detach() if s is None else s + sum_nll.detach()
            n = n_tok if n is None else n + n_tok
            c = n_correct if c is None else c + n_correct
        params = [p for p in state.model.parameters() if p.grad is not None]
        if d > 1:
            sums = mesh.all_reduce(torch.stack([s, n, c]), DATA_AXIS)
            s, n, c = sums[0], sums[1], sums[2]
            for p in params:
                mesh.all_reduce(p.grad, DATA_AXIS)
        denom = n.clamp(min=1.0)
        with torch.no_grad():
            for p in params:
                p.grad.div_(denom)
        tp = tensor_parallel(state.model)
        if tp is None:
            state.optimizer.step()
        else:
            state.optimizer.step(norm=tp.grad_norm(state.model))
        state.step += 1
        return {"loss": s / denom, "accuracy": c / denom}

    return step
