"""Distortion regularizer, Mip-NeRF 360 paper Eq. 15 (counterpart of
``mipnerf360_tpu/losses/distortion.py``).

:func:`distortion_loss` is the exact O(N) cumulative form (midpoints are
sorted ascending, so |m_i - m_j| telescopes into prefix sums);
:func:`distortion_loss_quadratic` is the O(N^2) form, kept as its oracle.
"""
from __future__ import annotations

import torch

from ..parallel.collectives import global_sum, group_size


def _midpoints_and_dists(s_vals):
    mids = 0.5 * (s_vals[..., :-1] + s_vals[..., 1:])
    dists = s_vals[..., 1:] - s_vals[..., :-1]
    return mids, dists


def distortion_loss(s_vals, weights, reduction: str = "sum", group=None):
    """Exact O(N) distortion loss.

    s_vals: [..., N+1] (sorted ascending); weights: [..., N].
    reduction "sum": sum over all rays (the reference's scale); "mean": the
    per-ray mean, batch-size-invariant. Any other value raises. ``group``:
    the rays are this rank's rows of a batch split over the group, and the
    sum or mean is the global batch's.
    """
    mids, dists = _midpoints_and_dists(s_vals)
    cw = torch.cumsum(weights, dim=-1)
    cwm = torch.cumsum(weights * mids, dim=-1)
    excl_cw = torch.cat([torch.zeros_like(cw[..., :1]), cw[..., :-1]], dim=-1)
    excl_cwm = torch.cat([torch.zeros_like(cwm[..., :1]), cwm[..., :-1]], dim=-1)
    # sum_{i,j} w_i w_j |m_i - m_j| = 2 * sum_i w_i (m_i * CW_{<i} - CWM_{<i})
    pairwise = 2.0 * torch.sum(weights * (mids * excl_cw - excl_cwm), dim=-1)
    self_term = torch.sum(weights**2 * dists, dim=-1) / 3.0
    per_ray = pairwise + self_term
    if reduction not in ("mean", "sum"):  # a typo'd override must not
        raise ValueError(                 # silently become 4096x stronger
            f"distortion reduction must be 'mean' or 'sum', got {reduction!r}")
    if group is None:
        return torch.mean(per_ray) if reduction == "mean" else torch.sum(per_ray)
    total = global_sum(torch.sum(per_ray), group)
    return total / (per_ray.numel() * group_size(group)) if reduction == "mean" else total


def distortion_loss_quadratic(s_vals, weights):
    """O(N^2) form, the oracle for :func:`distortion_loss` (reduction sum)."""
    mids, dists = _midpoints_and_dists(s_vals)
    dm = torch.abs(mids[..., :, None] - mids[..., None, :])
    pairwise = torch.einsum("...i,...j,...ij->...", weights, weights, dm)
    self_term = torch.sum(weights**2 * dists, dim=-1) / 3.0
    return torch.sum(pairwise + self_term)
