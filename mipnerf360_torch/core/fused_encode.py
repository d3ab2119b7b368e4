"""Factored frustum->IPE encode: no 3x3 covariance tensors in the hot path
(counterpart of ``mipnerf360_tpu/core/fused_encode.py``).

Every matrix of the general path (``cast_rays`` + ``integrated_pos_enc``) is
rank-1-structured:

  lifted cov      Sigma = beta*I + gamma*delta delta^T        (delta = ray dir)
                  beta  = r_var,  gamma = t_var - r_var/||delta||^2
  contraction J   J     = a*I + b*muhat muhat^T               (muhat = mean/n)
                  a = (2n-1)/n^2,  b = 1/n^2 - a   (n>1; J=I inside the ball)

so with v = Sigma muhat and q = muhat^T Sigma muhat the IPE attenuation is

  sigma_k = a^2 (beta + gamma*(P delta)_k^2)
          + 2 a b (beta*(P muhat)_k^2 + gamma*(delta . muhat)*(P muhat)_k*(P delta)_k)
          + b^2 q (P muhat)_k^2

which needs only the projections P delta ([B, 21]) and P mu ([B, N, 21]).
"""
from __future__ import annotations

import torch

from .contract import _NORM_EPS
from .encoding import p_basis, scale_ipe
from .gaussians import conical_frustum_to_gaussian, cylinder_to_gaussian


def factored_ipe(t_vals, origins, directions, radii, ray_shape: str = "cone",
                 stable: bool = True, min_deg: int = 0, max_deg: int = 1):
    """IPE features straight from ray intervals.
    Returns [..., N, 42*(max_deg-min_deg)], equal to
    ``integrated_pos_enc(*cast_rays(...), min_deg, max_deg)``."""
    t0, t1 = t_vals[..., :-1], t_vals[..., 1:]
    if ray_shape == "cone":
        t_mean, t_var, r_var = conical_frustum_to_gaussian(t0, t1, radii,
                                                           stable=stable)
    elif ray_shape == "cylinder":
        t_mean, t_var, r_var = cylinder_to_gaussian(t0, t1, radii)
    else:
        raise ValueError(f"unknown ray_shape: {ray_shape!r}")

    p = p_basis(t_vals)                                      # [21, 3]
    d = directions                                           # [..., 3]
    d_mag_sq = torch.clamp(torch.sum(d * d, dim=-1, keepdim=True), min=1e-10)

    # Sigma = beta*I + gamma * d d^T   (lift_gaussian, diagonalized form)
    beta = r_var                                             # [..., N]
    gamma = t_var - r_var / d_mag_sq                         # [..., N]

    # World-space mean and its projection (the sin/cos phase).
    mu = origins[..., None, :] + d[..., None, :] * t_mean[..., None]  # [...,N,3]
    p_mu = torch.einsum("kc,...c->...k", p, mu)              # [..., N, 21]
    p_d = torch.einsum("kc,...c->...k", p, d)[..., None, :]  # [..., 1, 21]

    # Contraction scalars. Denominators use the _NORM_EPS-clamped n (not raw
    # n2): at mu ~ 0 the unselected outside branch would otherwise compute
    # x/0 = inf and poison the backward pass through torch.where.
    n2 = torch.sum(mu * mu, dim=-1)                          # [..., N]
    n = torch.sqrt(torch.clamp(n2, min=_NORM_EPS))
    inside = n2 <= 1.0
    one = torch.ones_like(n)
    a = torch.where(inside, one, (2.0 * n - 1.0) / (n * n))
    b = torch.where(inside, torch.zeros_like(n), 1.0 / (n * n) - a)

    # Per-point contracted-covariance scalars.
    d_dot_muhat = torch.sum(mu * d[..., None, :], dim=-1) / n  # delta . muhat
    q = beta + gamma * d_dot_muhat**2                         # muhat^T Sigma muhat
    p_muhat = p_mu / n[..., None]                             # (P muhat)_k

    sigma = (
        a[..., None] ** 2 * (beta[..., None] + gamma[..., None] * p_d**2)
        + 2.0 * (a * b)[..., None]
        * (beta[..., None] * p_muhat**2
           + (gamma * d_dot_muhat)[..., None] * p_muhat * p_d)
        + (b**2 * q)[..., None] * p_muhat**2
    )                                                         # [..., N, 21]

    # Contracted-mean phase: contract(mu) = scale * mu, so P contract(mu)
    # = scale * P mu (projection is linear).
    scale = torch.where(inside, one, (2.0 - 1.0 / n) / n)
    gamma_phase = scale[..., None] * p_mu

    return scale_ipe(gamma_phase, sigma, min_deg, max_deg)
