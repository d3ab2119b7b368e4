"""Unbounded-scene contraction and its analytic Jacobian
(counterpart of ``mipnerf360_tpu/core/contract.py``).

    contract(x) = x                         if ||x|| <= 1
                  (2 - 1/||x||) * x/||x||   otherwise

    J(x) = alpha * I + beta * x_hat x_hat^T,   n = ||x||, n > 1
    alpha = (2n - 1) / n^2,  alpha + beta = 1 / n^2
"""
from __future__ import annotations

import torch

# Floor on the norm to keep 1/n finite at the origin (inside the unit ball the
# contraction is the identity anyway, so the clamped values are never selected).
_NORM_EPS = 1e-10


def contract(x):
    """Per-point scene contraction, paper Eq. 10. x: [..., 3] -> [..., 3]."""
    n2 = torch.sum(x * x, dim=-1, keepdim=True)
    n = torch.sqrt(torch.clamp(n2, min=_NORM_EPS))
    scale = (2.0 - 1.0 / n) / n
    return torch.where(n2 <= 1.0, x, scale * x)


def contract_jacobian(x):
    """Analytic Jacobian of :func:`contract`. x: [..., 3] -> [..., 3, 3]."""
    n2 = torch.sum(x * x, dim=-1, keepdim=True)
    n = torch.sqrt(torch.clamp(n2, min=_NORM_EPS))
    xhat = x / n
    alpha = (2.0 * n - 1.0) / (n * n)          # tangential eigenvalue
    radial = 1.0 / (n * n)                     # radial eigenvalue
    beta = radial - alpha
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    outer = xhat[..., :, None] * xhat[..., None, :]
    j_out = alpha[..., None] * eye + beta[..., None] * outer
    inside = (n2 <= 1.0)[..., None]
    return torch.where(inside, eye, j_out)


def contract_gaussian(mean, cov):
    """Push a Gaussian (mean, cov) through the contraction via linearization,
    Sigma' = J Sigma J^T. mean: [..., 3], cov: [..., 3, 3]."""
    j = contract_jacobian(mean)
    new_mean = contract(mean)
    new_cov = torch.einsum("...ij,...jk,...lk->...il", j, cov, j)
    return new_mean, new_cov


def contract_isotropic(means, stds):
    """Push isotropic Gaussians (``means`` [..., 3], ``stds`` [...]) through
    the contraction by linearization, keeping them isotropic (Zip-NeRF): the
    mean by :func:`contract`, the std scaled by the cube root of the
    Jacobian's determinant at the mean, (2n - 1)^(2/3) / n^2 outside the
    unit ball (radial eigenvalue 1/n^2, tangential (2n - 1)/n^2 twice)."""
    n2 = torch.sum(means * means, dim=-1)
    n = torch.sqrt(torch.clamp(n2, min=_NORM_EPS))
    inside = n2 <= 1.0
    scale = torch.where(inside, torch.ones_like(n), (2.0 - 1.0 / n) / n)
    root = torch.pow(torch.clamp(2.0 * n - 1.0, min=0.0), 2.0 / 3.0) / (n * n)
    return (scale[..., None] * means,
            stds * torch.where(inside, torch.ones_like(n), root))
