"""Alpha-composite volume rendering (counterpart of
``mipnerf360_tpu/core/rendering.py``).

:func:`compute_alpha_weights` is the plain PyTorch version of the composite
kernel K1 (``ops/composite.py``): the CPU path, and what the kernel is held
against on the card.
"""
from __future__ import annotations

import torch


def compute_alpha_weights(density, t_vals, dirs):
    """Density -> per-interval compositing weights.

    density: [..., N] (already activated); t_vals: [..., N+1]; dirs: [..., 3].
    Returns (weights [..., N], trans [..., N]).
    """
    t_dists = t_vals[..., 1:] - t_vals[..., :-1]
    delta = t_dists * torch.linalg.norm(dirs[..., None, :], dim=-1)
    density_delta = density * delta

    # -expm1, not 1-exp: the latter underflows to exactly 0 (killing all
    # gradients through alpha) already at density*delta ~ 3e-8; expm1 keeps
    # alpha (and its cotangent) alive down to f32 denormals.
    alpha = -torch.expm1(-density_delta)
    trans = torch.exp(-torch.cat(
        [torch.zeros_like(density_delta[..., :1]),
         torch.cumsum(density_delta[..., :-1], dim=-1)], dim=-1))
    return alpha * trans, trans


def composite_outputs(rgb, weights, t_vals, white_bkgd: bool):
    """Reduce per-sample rgb with precomputed weights into per-ray outputs.

    rgb: [..., N, 3]; weights: [..., N]; t_vals: [..., N+1].
    Returns (comp_rgb [..., 3], distance [...], acc [...]).
    """
    comp_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1)

    t_mids = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])
    distance = torch.sum(weights * t_mids, dim=-1) / acc
    distance = torch.clamp(torch.nan_to_num(distance, nan=0.0),
                           t_vals[..., 0], t_vals[..., -1])

    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - acc[..., None])
    return comp_rgb, distance, acc


def volumetric_rendering(rgb, density, t_vals, dirs, white_bkgd: bool):
    """Composite per-sample (rgb, density) into per-ray outputs.

    rgb: [..., N, 3]; density: [..., N]; t_vals: [..., N+1]; dirs: [..., 3].
    Returns (comp_rgb [..., 3], distance [...], acc [...], weights [..., N]).
    """
    weights, _ = compute_alpha_weights(density, t_vals, dirs)
    comp_rgb, distance, acc = composite_outputs(rgb, weights, t_vals, white_bkgd)
    return comp_rgb, distance, acc, weights
