"""Proposal-distillation loss, the interlevel supervision (counterpart of
``mipnerf360_tpu/losses/distillation.py``).

The bound is computed per ray from the NeRF level's weights, and the hinge
penalizes proposal weights that fall below that envelope. The bound carries
no gradient. Two forms compute it: the banded prefix-sum + binary-search form
and the broadcast overlap-mask einsum, its oracle. :func:`weight_bounds`
picks between them by the same byte threshold as the JAX package, so both
packages take the same form at the same shapes.
"""
from __future__ import annotations

import math

import torch

from ..parallel.collectives import all_reduce_, global_sum, group_size


@torch.no_grad()
def weight_bounds_einsum(t_fine, w_fine, t_coarse, data_shards: int = 1):
    """O(Nc*Nf) overlap-mask oracle for :func:`weight_bounds`.
    ``data_shards`` is ignored (call-compatibility with the dispatch).

    Materializes the full [..., Nc, Nf] overlap tensor.
    """
    t0 = t_fine[..., :-1]   # [..., Nf]
    t1 = t_fine[..., 1:]
    lo = t_coarse[..., :-1]  # [..., Nc]
    hi = t_coarse[..., 1:]
    # overlap[..., i, j] = fine interval j intersects coarse interval i
    overlap = ~((t0[..., None, :] > hi[..., :, None]) |
                (t1[..., None, :] < lo[..., :, None]))
    return torch.einsum("...ij,...j->...i", overlap.to(w_fine.dtype), w_fine)


@torch.no_grad()
def weight_bounds_banded(t_fine, w_fine, t_coarse, data_shards: int = 1):
    """For each coarse interval, sum the fine weights of overlapping intervals.

    t_fine: [..., Nf+1]; w_fine: [..., Nf]; t_coarse: [..., Nc+1].
    Returns bounds [..., Nc], without gradient. ``data_shards`` is ignored.

    Both grids are sorted per ray, so the fine intervals overlapping a coarse
    interval form a contiguous run: with prefix sums S of w_fine,
    bound_i = S[jhi_i] - S[jlo_i], where jlo_i is the first fine interval
    whose upper edge reaches lo_i and jhi_i counts those whose lower edge is
    at most hi_i (touching counts, as in the oracle's mask).
    """
    t0 = t_fine[..., :-1].contiguous()   # [..., Nf] (sorted)
    t1 = t_fine[..., 1:].contiguous()
    lo = t_coarse[..., :-1].contiguous()  # [..., Nc]
    hi = t_coarse[..., 1:].contiguous()
    prefix = torch.cat(
        [torch.zeros_like(w_fine[..., :1]), torch.cumsum(w_fine, dim=-1)], -1)
    jlo = torch.searchsorted(t1, lo, side="left")   # first j: t1[j] >= lo_i
    jhi = torch.searchsorted(t0, hi, side="right")  # count of t0[j] <= hi_i
    jhi = torch.maximum(jhi, jlo)                   # empty run -> bound 0
    return (torch.gather(prefix, -1, jhi) - torch.gather(prefix, -1, jlo))


# Above this many bytes of [.., Nc, Nf] einsum transient, the banded form
# takes over (the JAX package's threshold, so both packages pick the same
# form; see its losses/distillation.py for how it was set).
_BANDED_BYTES_THRESHOLD = 2 * 1024 * 1024 * 1024


def _einsum_transient_bytes(w_fine, nc: int, data_shards: int = 1) -> int:
    """Per-device bytes of the [.., Nc, Nf] overlap transient, with the batch
    split over ``data_shards`` devices."""
    batch = math.prod(w_fine.shape[:-1])
    itemsize = w_fine.element_size()
    return batch * nc * w_fine.shape[-1] * itemsize // max(1, data_shards)


def weight_bounds(t_fine, w_fine, t_coarse, data_shards: int = 1):
    """The bound: einsum at flagship shapes, banded when the quadratic
    overlap transient would exceed the per-device byte budget. The two forms
    agree exactly."""
    nc = t_coarse.shape[-1] - 1
    if _einsum_transient_bytes(w_fine, nc, data_shards) > _BANDED_BYTES_THRESHOLD:
        return weight_bounds_banded(t_fine, w_fine, t_coarse)
    return weight_bounds_einsum(t_fine, w_fine, t_coarse)


def proposal_loss(w_coarse, bounds, eps: float = 1e-6, group=None):
    """Hinge loss sum(relu(bound - w)^2 / (w + eps)) / batch; with
    ``group``, over the global batch split across the group."""
    batch = bounds.shape[0] * group_size(group)
    hinge = torch.clamp(bounds - w_coarse, min=0.0)
    return global_sum(torch.sum(hinge**2 / (w_coarse + eps)), group) / batch


def distillation_loss(t_fine, w_fine, t_coarse, w_coarse,
                      collapsed: bool = False, data_shards: int = 1,
                      group=None):
    """Bounds + hinge in one call.

    ``collapsed=True`` reproduces the reference's batch-collapse quirk: each
    bound is the sum of every ray's per-ray bound, broadcast back to all
    rays. The default is the intended per-ray bound. ``data_shards`` sizes
    the per-device einsum transient for the dispatch; a rank of the port
    holds only its own rows already, so it passes 1 where the JAX package
    passes the data axis. ``group``: the rays are this rank's rows of a
    batch split over the group; the collapsed bound and the hinge are the
    global batch's.
    """
    b = weight_bounds(t_fine, w_fine, t_coarse, data_shards)
    if collapsed:
        b = torch.sum(b, dim=0, keepdim=True)
        if group is not None:
            b = all_reduce_(b, group)   # the bound carries no gradient
    return proposal_loss(w_coarse, b.expand(w_coarse.shape), group=group)
