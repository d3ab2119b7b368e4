"""Depth/normal visualization + image conversion helpers (host-side NumPy;
from ``mipnerf360_tpu/data/viz.py``, with the options ``apps/eval.py`` sets:
``visualize_depth`` between given near and far planes).

matplotlib's turbo colormap is used when available, sinebow as fallback.
"""
from __future__ import annotations

import numpy as np


def to8b(img: np.ndarray) -> np.ndarray:
    return (255 * np.clip(np.nan_to_num(img), 0, 1)).astype(np.uint8)


def _convolve2d_same(z, f):
    """Small 'same'-mode 2D convolution (no scipy dependency)."""
    fh, fw = f.shape
    ph, pw = fh // 2, fw // 2
    zp = np.pad(z, ((ph, ph), (pw, pw)))
    out = np.zeros_like(z, dtype=np.float64)
    for i in range(fh):
        for j in range(fw):
            out += f[i, j] * zp[i:i + z.shape[0], j:j + z.shape[1]]
    return out


def depth_to_normals(depth):
    """Linearize an orthographic depth map to normals."""
    f_blur = np.array([1, 2, 1]) / 4.0
    f_edge = np.array([-1, 0, 1]) / 2.0
    dy = _convolve2d_same(depth, f_blur[None, :] * f_edge[:, None])
    dx = _convolve2d_same(depth, f_blur[:, None] * f_edge[None, :])
    inv_denom = 1.0 / np.sqrt(1.0 + dx**2 + dy**2)
    return np.stack([dx * inv_denom, dy * inv_denom, inv_denom], -1)


def sinebow(h):
    f = lambda x: np.sin(np.pi * x) ** 2
    return np.stack([f(3 / 6 - h), f(5 / 6 - h), f(7 / 6 - h)], -1)


def _turbo_or_sinebow():
    try:
        import matplotlib

        turbo = matplotlib.colormaps["turbo"]
        return lambda v: np.asarray(turbo(v))[..., :3]
    except Exception:
        return sinebow


def visualize_normals(depth, acc):
    """Fake-normal visualization of a depth map."""
    mask = ~np.isnan(depth)
    x, y = np.meshgrid(
        np.arange(depth.shape[1]), np.arange(depth.shape[0]), indexing="xy")
    xy_var = (np.var(x[mask]) + np.var(y[mask])) / 2
    z_var = max(np.var(depth[mask]), 1e-12)
    normals = depth_to_normals(np.sqrt(xy_var / z_var) * depth)
    vis = np.isnan(normals) + np.nan_to_num((normals + 1) / 2, 0)
    return vis * acc[:, :, None] + (1 - acc)[:, :, None]


def visualize_depth(depth, acc, near: float, far: float):
    """Colormapped depth visualization: -log depth between the near and far
    planes, composited over white by ``acc``."""
    depth = np.asarray(depth)
    acc = np.where(np.isnan(depth), np.zeros_like(acc), acc)
    curve = lambda x: -np.log(np.asarray(x, np.float64) + np.finfo(np.float32).eps)
    depth, near, far = curve(depth), curve(near), curve(far)
    value = np.nan_to_num(
        np.clip((depth - np.minimum(near, far)) / np.abs(far - near), 0, 1))
    vis = _turbo_or_sinebow()(value)[..., :3]
    return vis * acc[:, :, None] + (1 - acc)[:, :, None]
