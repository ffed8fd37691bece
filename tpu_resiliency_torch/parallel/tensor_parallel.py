"""Tensor-parallel collectives of the sharded train step.

The JAX model (``tpu_resiliency/models/transformer.py:123-156``) places its
weights with ``NamedSharding`` and constrains activations with
``with_sharding_constraint``; GSPMD then inserts the collectives.  Eager
PyTorch has no such pass, so the port writes the three it needs, each an
autograd function over the mesh's ``"model"`` process group:

- :func:`copy_to_tp`: identity forward, all-reduce (sum) backward.  It
  stands before a column-split matmul (``wq``/``wk``/``wv``/``w1`` and the
  tied logits): each rank's input gradient is a partial sum over its
  columns.
- :func:`reduce_from_tp`: all-reduce (sum) forward, identity backward.  It
  stands after a row-split matmul (``wo``/``w2``) and the vocab-split
  embedding lookup, whose outputs are partial sums.
- :func:`gather_from_tp`: all-gather along the last dimension forward,
  this rank's slice backward.  It makes the vocab-split logits whole, as
  the JAX logits are constrained replicated; what follows is computed
  alike on every rank, so the slice of the gradient is the whole of it.

The data-parallel mean of the loss is the fourth, :func:`mean_over`: the
local means averaged over ``"data"`` forward, the gradient divided by the
axis size backward (the step then sums the gradients over ``"data"``).

Only ``all_reduce`` and ``all_gather`` are used: gloo has both for CUDA
tensors (and no ``reduce_scatter`` there), so the same code runs over NCCL
and over gloo ranks that share one card.  Over a group of one rank each
function returns its input and issues no collective, so a ``(dp, 1)``
mesh runs the unsharded arithmetic.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _size(group: Optional["dist.ProcessGroup"]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.rank = dist.get_rank(group)
        ctx.width = x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return _all_reduce(x, group) / ctx.n

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient is all-reduced over ``group``."""
    return x if _size(group) == 1 else _CopyToTp.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) over ``group`` forward; identity backward."""
    return x if _size(group) == 1 else _ReduceFromTp.apply(x, group)


def gather_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather along the last dimension over ``group`` (rank order)
    forward; this rank's slice of the gradient backward."""
    return x if _size(group) == 1 else _GatherFromTp.apply(x, group)


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group`` forward; the gradient divided by
    the group's size backward."""
    return x if _size(group) == 1 else _MeanOver.apply(x, group)
