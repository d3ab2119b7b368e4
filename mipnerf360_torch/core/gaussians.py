"""Conical/cylindrical frustum -> Gaussian moments, lifted to world space
(counterpart of ``mipnerf360_tpu/core/gaussians.py``)."""
from __future__ import annotations

import torch

from .contract import contract_gaussian


def conical_frustum_to_gaussian(t0, t1, base_radius, stable: bool = True):
    """Moments (t_mean, t_var, r_var) of a conical frustum along its axis:
    the numerically stable Mip-NeRF forms by default, with the closed-form
    unstable variant kept as an independent oracle for tests.

    t0, t1: [..., N] interval edges; base_radius: [..., 1] radius per unit t.
    """
    if stable:
        mu = (t0 + t1) / 2.0
        hw = (t1 - t0) / 2.0
        denom = 3.0 * mu**2 + hw**2
        t_mean = mu + (2.0 * mu * hw**2) / denom
        t_var = hw**2 / 3.0 - (4.0 / 15.0) * (hw**4 * (12.0 * mu**2 - hw**2)) / denom**2
        r_var = base_radius**2 * (mu**2 / 4.0 + (5.0 / 12.0) * hw**2 - (4.0 / 15.0) * hw**4 / denom)
    else:
        t_mean = (3.0 * (t1**4 - t0**4)) / (4.0 * (t1**3 - t0**3))
        r_var = base_radius**2 * (3.0 / 20.0 * (t1**5 - t0**5) / (t1**3 - t0**3))
        t_mosq = 3.0 / 5.0 * (t1**5 - t0**5) / (t1**3 - t0**3)
        t_var = t_mosq - t_mean**2
    return t_mean, t_var, r_var


def cylinder_to_gaussian(t0, t1, base_radius):
    """Moments of a cylinder spanning [t0, t1] with the given radius:
    t_mean = midpoint, t_var = (t1-t0)^2/12, r_var = r^2/4."""
    t_mean = (t0 + t1) / 2.0
    t_var = (t1 - t0) ** 2 / 12.0
    r_var = base_radius**2 / 4.0
    return t_mean, t_var, r_var


def lift_gaussian(directions, t_mean, t_var, r_var, diag: bool = False):
    """Lift axis-aligned frustum moments to a world-space Gaussian.

    directions: [..., 3]; t_mean/t_var/r_var: [..., N].
    Returns mean [..., N, 3] and cov [..., N, 3, 3] (or diag [..., N, 3]).
    """
    mean = directions[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(directions**2, dim=-1, keepdim=True), min=1e-10)
    if diag:
        d_outer_diag = directions**2
        null_outer_diag = 1.0 - d_outer_diag / d_mag_sq
        t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
        xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
        return mean, t_cov_diag + xy_cov_diag
    d_outer = directions[..., :, None] * directions[..., None, :]
    eye = torch.eye(3, dtype=directions.dtype, device=directions.device)
    null_outer = eye - directions[..., :, None] * (directions / d_mag_sq)[..., None, :]
    t_cov = t_var[..., None, None] * d_outer[..., None, :, :]
    xy_cov = r_var[..., None, None] * null_outer[..., None, :, :]
    return mean, t_cov + xy_cov


def cast_rays(t_vals, origins, directions, radii, ray_shape: str = "cone",
              do_contract: bool = True, stable: bool = True):
    """Cast each ray interval to a (contracted) world-space Gaussian: the
    general (``factored_encode=False``) path, and the oracle of
    :func:`..core.fused_encode.factored_ipe`.

    t_vals: [..., N+1] edges -> means [..., N, 3], covs [..., N, 3, 3].
    """
    t0 = t_vals[..., :-1]
    t1 = t_vals[..., 1:]
    if ray_shape == "cone":
        t_mean, t_var, r_var = conical_frustum_to_gaussian(t0, t1, radii, stable=stable)
    elif ray_shape == "cylinder":
        t_mean, t_var, r_var = cylinder_to_gaussian(t0, t1, radii)
    else:
        raise ValueError(f"unknown ray_shape: {ray_shape!r}")
    means, covs = lift_gaussian(directions, t_mean, t_var, r_var, diag=False)
    means = means + origins[..., None, :]
    if do_contract:
        means, covs = contract_gaussian(means, covs)
    return means, covs
