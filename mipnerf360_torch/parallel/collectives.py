"""Collectives over a process subgroup, with the backward each use needs.

Only ``all_reduce`` and ``broadcast`` are used: NCCL and gloo both take CUDA
tensors for these two, so the same code runs on the card over NCCL, and on
the CPU (or two ranks sharing one card) over gloo. A gather is an
``all_reduce`` of a zero buffer in which each rank has filled its own slot,
which is exact.

The port runs one process per rank, and every rank of a group computes the
same loss from the group's statistics. That fixes each backward:

- a sum of per-rank partials that every rank then uses alike
  (:func:`global_sum`) passes its cotangent through unchanged: each rank's
  partial reached the one loss once;
- a gathered value that the ranks use differently (the sample-axis prefix,
  ``parallel/sample_axis.py``) takes the sum of every rank's cotangent, and
  each rank keeps its own slot (:func:`gather`, ``sum_backward=True``); one
  that every rank uses alike keeps its own slot of its own cotangent.

Megatron's pair for the tensor-parallel trunk follows the same rules and
lives in ``models/mlp.py::_MatmulF32``: the row-split layer sums its
output forward with an identity backward, the column-split layer sums its
input's gradient backward.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """Ranks in ``group`` (1 for None: no group, one rank)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index inside ``group`` (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place (no autograd); returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def flat_all_reduce(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The sums over ``group`` of same-dtype ``tensors``, through one flat
    buffer: one collective however many tensors (no autograd)."""
    return _unflat(all_reduce_(_flat(tensors), group), tensors)


def flat_broadcast_(tensors: Sequence[torch.Tensor], src: int = 0,
                    group=None) -> None:
    """Overwrite same-dtype ``tensors`` with global rank ``src``'s values,
    through one flat buffer (no autograd)."""
    flat = _flat(tensors)
    dist.broadcast(flat, src=src, group=group)
    with torch.no_grad():
        for t, v in zip(tensors, _unflat(flat, tensors)):
            t.copy_(v)


def gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (all of one shape) concatenated along ``dim`` in
    rank order, on every rank of ``group`` (no autograd): an all_reduce of
    zeros in which each rank fills its own slot."""
    dim = dim % x.dim()
    n, p = x.shape[dim], group_size(group)
    shape = list(x.shape)
    shape[dim] = n * p
    buf = x.new_zeros(shape)
    buf.narrow(dim, group_rank(group) * n, n).copy_(x)
    return all_reduce_(buf, group)


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, with the identity backward (every
    rank then uses the sum alike). ``group`` None: ``x`` itself."""
    return x if group is None else _GlobalSum.apply(x, group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, sum_backward):
        ctx.group, ctx.dim, ctx.n = group, dim % x.dim(), x.shape[dim]
        ctx.sum_backward = sum_backward
        return gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_backward:
            g = all_reduce_(g.contiguous().clone(), ctx.group)
        return (g.narrow(ctx.dim, group_rank(ctx.group) * ctx.n, ctx.n),
                None, None, None)


def gather(x: torch.Tensor, group, dim: int = 0, *,
           sum_backward: bool) -> torch.Tensor:
    """:func:`gather_cat` under autograd. ``sum_backward``: the ranks use
    the gathered value differently, so each slot's gradient is the sum of
    every rank's; otherwise every rank uses it alike and keeps its own
    slot's gradient."""
    return _Gather.apply(x, group, dim, sum_backward)
