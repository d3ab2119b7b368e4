"""Conical/cylindrical frustum -> Gaussian moments, lifted to world space
(counterpart of ``mipnerf360_tpu/core/gaussians.py``), and Zip-NeRF's
multisampled frustum (:func:`multisample_cast`), which the JAX package does
not have."""
from __future__ import annotations

import math

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


# Zip-NeRF's multisampling: each interval as this many isotropic Gaussians,
# at these multiples of pi/3 around the ray (a hexagon that spirals along
# the frustum).
MULTISAMPLES = 6
PATTERN_ANGLES = (0, 2, 4, 3, 5, 1)


def ray_basis(directions):
    """Two unit vectors u, v [..., 3] that make an orthonormal basis with
    the unit direction n = d / |d| (Duff et al. 2017, branchless)."""
    n = directions / torch.linalg.vector_norm(directions, dim=-1,
                                              keepdim=True)
    x, y, z = n.unbind(-1)
    s = torch.copysign(torch.ones_like(z), z)
    a = -1.0 / (s + z)
    b = x * y * a
    u = torch.stack([1.0 + s * x * x * a, s * b, -s * x], dim=-1)
    v = torch.stack([b, s + y * y * a, -y], dim=-1)
    return u, v


def multisample_cast(t_vals, origins, directions, radii, turn=None,
                     mirror=None):
    """Zip-NeRF's cast of each interval [t0, t1] of a cone ray: means [...,
    N, 6, 3] and stds [..., N, 6] of ``MULTISAMPLES`` isotropic Gaussians.

    Point j sits at t_j, placed so that the six match the frustum's mean
    and variance along the ray, at angle theta_j = pi/3 PATTERN_ANGLES[j]
    around it, r t_j / sqrt(2) off the axis, with std 0.5 r t_j / sqrt(2)
    (r = ``radii``, [..., 1]). With ``turn`` and ``mirror`` ([..., N]
    uniforms in [0, 1)), interval i's pattern is turned by 2 pi turn[i] and
    mirrored (theta -> 5 pi/3 - theta) where mirror[i] < 0.5 (training);
    without them every odd interval's is turned by pi/6 and mirrored
    (rendering)."""
    t0, t1 = t_vals[..., :-1, None], t_vals[..., 1:, None]
    tm, td = (t0 + t1) / 2.0, (t1 - t0) / 2.0
    j = torch.arange(MULTISAMPLES, dtype=t_vals.dtype, device=t_vals.device)
    spread = 3.0 / math.sqrt(7.0) * (2.0 * j / (MULTISAMPLES - 1) - 1.0)
    root = torch.sqrt((td**2 - tm**2) ** 2 + 4.0 * tm**4)
    t = t0 + td / (td**2 + 3.0 * tm**2) * (t1**2 + 2.0 * tm**2
                                           + spread * root)  # [..., N, 6]
    base = torch.tensor(PATTERN_ANGLES, dtype=t_vals.dtype,
                        device=t_vals.device) * (math.pi / 3.0)
    if turn is None:
        odd = (torch.arange(t.shape[-2], device=t_vals.device) % 2 == 1)
        theta = torch.where(odd[:, None], 5.0 * math.pi / 3.0
                            - (base + math.pi / 6.0), base)
        theta = theta.expand(t.shape)
    else:
        theta = base + 2.0 * math.pi * turn[..., None]
        theta = torch.where(mirror[..., None] < 0.5,
                            5.0 * math.pi / 3.0 - theta, theta)
    u, v = ray_basis(directions)
    off = radii[..., None, :] * t / math.sqrt(2.0)            # [..., N, 6]
    lateral = (torch.cos(theta)[..., None] * u[..., None, None, :]
               + torch.sin(theta)[..., None] * v[..., None, None, :])
    means = (origins[..., None, None, :]
             + t[..., None] * directions[..., None, None, :]
             + off[..., None] * lateral)
    return means, 0.5 * off
