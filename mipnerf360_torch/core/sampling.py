"""Stratified s-space sampling and inverse-CDF hierarchical resampling
(counterpart of ``mipnerf360_tpu/core/sampling.py``).

Where the JAX functions draw from a ``jax.random`` key, these take an optional
explicit ``noise`` tensor (so a test can feed the very numbers JAX drew) or
else draw from an optional ``torch.Generator``.

The reference's randomized inverse-CDF draw ``u = 2*u + noise`` is a typo for
stratified ``u + noise``; the correct draw is the default, with the typo
reproducible behind ``u_typo=True`` (``ModelConfig.resample_u_typo``).
"""
from __future__ import annotations

import numpy as np
import torch

from .spacing import s_to_t

_F32_EPS = np.finfo(np.float32).eps


def linspace_from_zero(stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(0, stop, num, dtype=float32)`` bit for bit.

    ``torch.linspace`` differs from it by an ulp in most entries of e.g.
    ``linspace(0, 1 - eps, 64)``, which can move a sample across a CDF
    interval edge. So does JAX's own formula ``stop * (iota / (num - 1))``
    evaluated as written: XLA rewrites the division into a product with the
    float32 reciprocal and folds that into the constant, giving
    ``iota * (f32(1 / (num - 1)) * stop)`` with ``stop`` appended
    (tests/test_torch_sampling.py checks the bits)."""
    stop = np.float32(stop)
    if num == 1:
        return np.zeros(1, np.float32)
    div = num - 1
    scale = (np.float32(1) / np.float32(div)) * stop
    return np.append(np.arange(div, dtype=np.float32) * scale,
                     stop).astype(np.float32)


def _uniform(shape, like: torch.Tensor, generator=None):
    """U[0, 1) draws of ``like``'s dtype on ``like``'s device, from
    ``generator`` (which may live on another device)."""
    dev = generator.device if generator is not None else like.device
    u = torch.rand(shape, generator=generator, dtype=like.dtype, device=dev)
    return u.to(like.device)


def stratified_jitter(shape, like: torch.Tensor, generator=None):
    """The randomized inverse-CDF draw's jitter for ``shape[-1]`` samples,
    U[0, 1/n - eps), drawn as :func:`sorted_piecewise_constant_pdf` draws
    it when it is given no noise."""
    return _uniform(shape, like, generator) * float(
        np.float32(1.0 / shape[-1]) - _F32_EPS)


def sorted_piecewise_constant_pdf(bins, weights, num_samples: int,
                                  randomized: bool, u_typo: bool = False, *,
                                  noise=None, generator=None):
    """Draw samples from the piecewise-constant PDF defined by (bins, weights).

    bins: [..., N+1] sorted edges; weights: [..., N] non-negative.
    Returns samples [..., num_samples], sorted ascending. ``noise``
    ([..., num_samples], in [0, 1/num_samples - eps)) is the stratified
    jitter of the randomized branch; drawn from ``generator`` when None.
    """
    # Pad so near-zero weight vectors still define a valid PDF.
    eps = 1e-5
    weight_sum = torch.sum(weights, dim=-1, keepdim=True)
    padding = torch.clamp(eps - weight_sum, min=0.0)
    weights = weights + padding / weights.shape[-1]
    weight_sum = weight_sum + padding

    pdf = weights / weight_sum
    cdf = torch.clamp(torch.cumsum(pdf[..., :-1], dim=-1), max=1.0)
    cdf = torch.cat(
        [torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], dim=-1
    )  # [..., N+1]

    s = 1.0 / num_samples
    shape = cdf.shape[:-1] + (num_samples,)
    if randomized:
        base = torch.arange(num_samples, dtype=cdf.dtype, device=cdf.device) * s
        if noise is None:
            noise = stratified_jitter(shape, cdf, generator)
        u = torch.clamp((base + base if u_typo else base) + noise,
                        max=float(np.float32(1.0) - _F32_EPS))
    else:
        u = torch.as_tensor(linspace_from_zero(1.0 - _F32_EPS, num_samples),
                            device=cdf.device).to(cdf.dtype)
        u = u.expand(shape)

    # Interval search by broadcast compare: mask[..., i, j] = u_j >= cdf_i.
    # For each sample, the highest True row is the left edge of its interval.
    mask = u[..., None, :] >= cdf[..., :, None]

    def find_interval(x):
        x0 = torch.amax(torch.where(mask, x[..., None], x[..., :1, None]), dim=-2)
        x1 = torch.amin(torch.where(~mask, x[..., None], x[..., -1:, None]), dim=-2)
        return x0, x1

    bins_g0, bins_g1 = find_interval(bins)
    cdf_g0, cdf_g1 = find_interval(cdf)

    denom = cdf_g1 - cdf_g0
    t = torch.clamp(torch.nan_to_num((u - cdf_g0) / denom, nan=0.0), 0.0, 1.0)
    return bins_g0 + t * (bins_g1 - bins_g0)


def sample_along_rays(near, far, num_samples: int, randomized: bool, *,
                      noise=None, generator=None):
    """Sample ``num_samples + 1`` t-edges uniformly in disparity (s) space.

    near/far: [B, 1]. Returns t_vals [B, N+1]. ``noise`` ([B, N+1] in
    [0, 1)) jitters each edge within its stratum when ``randomized``; drawn
    from ``generator`` when None.
    """
    batch = near.shape[0]
    s_vals = torch.as_tensor(linspace_from_zero(1.0, num_samples + 1),
                             device=near.device).to(near.dtype)
    t_vals = s_to_t(s_vals, near, far)  # [B, N+1] via broadcasting
    if randomized:
        mids = 0.5 * (t_vals[..., 1:] + t_vals[..., :-1])
        upper = torch.cat([mids, t_vals[..., -1:]], dim=-1)
        lower = torch.cat([t_vals[..., :1], mids], dim=-1)
        if noise is None:
            noise = _uniform((batch, num_samples + 1), near, generator)
        t_vals = lower + (upper - lower) * noise
    else:
        t_vals = t_vals.expand(batch, num_samples + 1)
    return t_vals


def blur_weights(weights):
    """Max-pool-of-neighbors then average — the proposal weight blur, which
    widens the histogram before resampling."""
    w_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]], dim=-1)
    w_max = torch.maximum(w_pad[..., :-1], w_pad[..., 1:])
    return 0.5 * (w_max[..., :-1] + w_max[..., 1:])


@torch.no_grad()
def resample_along_rays(t_vals, weights, randomized: bool,
                        resample_padding: float, u_typo: bool = False, *,
                        noise=None, generator=None, num_edges=None):
    """Hierarchical resampling of ``num_edges`` new edges (by default
    ``t_vals.shape[-1]``, as many as there were).

    The weight histogram is blurred, padded, and inverse-CDF sampled. It runs
    under ``torch.no_grad``: sampling locations carry no gradients (the JAX
    package's ``stop_gradient``).
    """
    w = blur_weights(weights) + resample_padding
    return sorted_piecewise_constant_pdf(
        t_vals, w, num_edges or t_vals.shape[-1], randomized, u_typo=u_typo,
        noise=noise, generator=generator)
