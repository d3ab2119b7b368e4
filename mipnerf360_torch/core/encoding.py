"""Integrated positional encoding (IPE) and view-direction encoding
(counterpart of ``mipnerf360_tpu/core/encoding.py``).

The position encoder projects contracted means through the fixed 21-row basis
of icosahedral directions from the Mip-NeRF 360 paper and attenuates by
exp(-sigma/2) where sigma_k = p_k^T Sigma p_k, at 2^i frequency scales for i
in [min_deg, max_deg): 42 features per scale. The view-direction encoder maps
(theta, phi) angles through 2^i scales, 4 features per scale.
"""
from __future__ import annotations

import numpy as np
import torch

# The exact 21x3 icosahedron-derived constant used by the paper and the
# reference, pinned for parity.
P_BASIS = np.array(
    [
        [0.8506508, 0.0, 0.5257311],
        [0.809017, 0.5, 0.309017],
        [0.5257311, 0.8506508, 0.0],
        [1.0, 0.0, 0.0],
        [0.809017, 0.5, -0.309017],
        [0.8506508, 0.0, -0.5257311],
        [0.309017, 0.809017, -0.5],
        [0.0, 0.5257311, -0.8506508],
        [0.5, 0.309017, -0.809017],
        [0.0, 1.0, 0.0],
        [-0.5257311, 0.8506508, 0.0],
        [-0.309017, 0.809017, -0.5],
        [0.0, 0.5257311, 0.8506508],
        [-0.309017, 0.809017, 0.5],
        [0.309017, 0.809017, 0.5],
        [0.5, 0.309017, 0.809017],
        [0.5, -0.309017, 0.809017],
        [0.0, 0.0, 1.0],
        [-0.5, 0.309017, 0.809017],
        [-0.809017, 0.5, 0.309017],
        [-0.809017, 0.5, -0.309017],
    ],
    dtype=np.float32,
)

POS_ENC_DIM = 2 * P_BASIS.shape[0]  # 42 (per scale)


def pos_enc_dim(min_deg: int = 0, max_deg: int = 1) -> int:
    return POS_ENC_DIM * (max_deg - min_deg)


def p_basis(like: torch.Tensor) -> torch.Tensor:
    """``P_BASIS`` as a tensor of ``like``'s dtype and device."""
    return torch.as_tensor(P_BASIS, dtype=like.dtype, device=like.device)


def scale_ipe(gamma, sigma, min_deg: int, max_deg: int):
    """Expand single-scale IPE phases/attenuations to 2^i frequency scales:
    phase -> 2^i * gamma, attenuation sigma -> 4^i * sigma.
    Returns [..., 42*(max_deg-min_deg)] features."""
    outs = []
    for i in range(min_deg, max_deg):
        g = gamma * (2.0 ** i)
        attn = torch.exp(-0.5 * (4.0 ** i) * sigma)
        outs.append(attn * torch.sin(g))
        outs.append(attn * torch.cos(g))
    return torch.cat(outs, dim=-1)


def integrated_pos_enc(mean, cov=None, min_deg: int = 0, max_deg: int = 1):
    """IPE features from a (contracted) Gaussian.

    mean: [..., 3]; cov: [..., 3, 3] or None (plain PE).
    Returns [..., 42*(max_deg-min_deg)].
    """
    p = p_basis(mean)
    gamma = torch.einsum("kd,...d->...k", p, mean)
    if cov is None:
        sigma = torch.zeros_like(gamma)
    else:
        sigma = torch.einsum("ka,...ab,kb->...k", p, cov, p)
    return scale_ipe(gamma, sigma, min_deg, max_deg)


def viewdir_enc(viewdirs, min_deg: int = 0, max_deg: int = 4):
    """Angular view-direction encoding.

    viewdirs: [..., 3] unit vectors -> [..., 4*(max_deg-min_deg)] features.
    """
    x = viewdirs[..., 0:1]
    y = viewdirs[..., 1:2]
    z = viewdirs[..., 2:3]
    theta = torch.arccos(torch.clamp(z, -1.0, 1.0))
    # Reference quirk kept for parity: arctan (not arctan2), so azimuth folds
    # into (-pi/2, pi/2) and the +1e-6 shifts the pole. At x == -1e-6 exactly,
    # y/(x+1e-6) is 0/0 -> NaN for y == 0; substituting a tiny denominator
    # preserves the arctan limit (±pi/2 for y != 0, 0 for y == 0) without
    # changing any other value.
    denom = x + 1e-6
    safe = torch.where(denom == 0.0,
                       torch.full_like(denom, torch.finfo(viewdirs.dtype).tiny),
                       denom)
    phi = torch.arctan(y / safe)
    scales = torch.tensor([2.0**i for i in range(min_deg, max_deg)],
                          dtype=viewdirs.dtype, device=viewdirs.device)
    theta_s = theta * scales
    phi_s = phi * scales
    return torch.cat(
        [torch.sin(theta_s), torch.cos(theta_s), torch.sin(phi_s), torch.cos(phi_s)], dim=-1
    )


def viewdir_enc_dim(min_deg: int = 0, max_deg: int = 4) -> int:
    return 4 * (max_deg - min_deg)


def unit_viewdir_enc(viewdirs, min_deg: int = 0, max_deg: int = 4):
    """The published network's view-direction encoding (multinerf's
    ``pos_enc`` with the identity appended first): the unit vector, then
    sin of its coordinates at 2^i (scale-major), then sin of the same plus
    pi/2, as there (not cos).

    viewdirs: [..., 3] -> [..., 3 + 6*(max_deg-min_deg)] features.
    """
    scales = torch.tensor([2.0**i for i in range(min_deg, max_deg)],
                          dtype=viewdirs.dtype, device=viewdirs.device)
    x = (viewdirs[..., None, :] * scales[:, None]).reshape(
        viewdirs.shape[:-1] + (-1,))
    return torch.cat(
        [viewdirs, torch.sin(torch.cat([x, x + 0.5 * np.pi], dim=-1))], dim=-1)
