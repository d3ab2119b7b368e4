"""Procedural multi-view scene (host-side NumPy; counterpart of
``mipnerf360_tpu/data/synthetic.py``).

A shaded sphere at the origin, rendered analytically from cameras on a
tilted circle: a geometrically consistent scene that needs no data on disk.
Every split gives the same arrays as the JAX package's.
"""
from __future__ import annotations

import numpy as np

from ..config import DataConfig
from .base import LazyRenderDataset, RayDataset, flatten_images
from .pose import look_at, normalize, spherical_path
from .rays_gen import pinhole_rays


def _orbit_poses_at(angles, radius: float = 4.0, elevation: float = 0.5):
    """Cameras on a tilted circle at the given angles, looking at the origin."""
    poses = []
    for th in angles:
        pos = np.array([
            radius * np.cos(th),
            radius * np.sin(th),
            radius * elevation * np.sin(th * 2 + 1.0),
        ])
        z = normalize(pos)  # camera looks along -z toward origin
        up = np.array([0.0, 0.0, 1.0])
        poses.append(look_at(z, up, pos))
    return np.stack(poses, 0).astype(np.float32)


def _train_angles(n_views: int) -> np.ndarray:
    return np.linspace(0, 2 * np.pi, n_views + 1)[:-1]


def _test_angles(n_views: int) -> np.ndarray:
    """Holdout angles disjoint from every train angle: midpoints of evenly
    spaced train intervals."""
    n_test = max(2, n_views // 4)
    train = _train_angles(n_views)
    step = 2 * np.pi / n_views
    picks = np.linspace(0, n_views - 1, n_test).astype(int)
    return train[picks] + 0.5 * step


def _shade_sphere(origins, viewdirs, sphere_radius: float = 1.0,
                  background: float = 1.0):
    """Analytic render: lambertian sphere at origin on a constant background.

    origins/viewdirs: [..., 3] -> rgb [..., 3] float32 in [0, 1].
    ``background`` 1.0 (white) pairs with white_bkgd=True, 0.0 (black) with
    white_bkgd=False.
    """
    o = origins
    d = viewdirs
    b = np.sum(o * d, axis=-1)
    c = np.sum(o * o, axis=-1) - sphere_radius**2
    disc = b * b - c
    hit = disc > 0
    sqrt_disc = np.sqrt(np.maximum(disc, 0.0))
    t_hit = -b - sqrt_disc
    hit = hit & (t_hit > 0)
    p = o + t_hit[..., None] * d
    n = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
    light = normalize(np.array([0.5, 0.5, 0.8]))
    lambert = np.clip(np.sum(n * light, axis=-1), 0.0, 1.0)
    base = 0.5 * (n + 1.0)  # normal-coded albedo: view-consistent color
    rgb = base * (0.25 + 0.75 * lambert[..., None])
    bg = np.full_like(rgb, background)
    return np.where(hit[..., None], rgb, bg).astype(np.float32)


def synthetic_dataset(cfg: DataConfig, split: str = "train",
                      background: float = 1.0):
    res = cfg.synthetic_resolution
    n_views = cfg.synthetic_views
    focal = 0.9 * res
    if split == "render":
        # A spherical orbit at the scene's own resolution and focal (the
        # scene is a 360 orbit; the spiral path is for forward-facing
        # scenes), generated one pose at a time.
        poses = spherical_path(cfg.render_radius, n_views)[:, :3, :4]
        poses = np.ascontiguousarray(poses, dtype=np.float32)

        def ray_fn(p):
            rays = pinhole_rays(p, res, res, focal, cfg.near, cfg.far)
            return flatten_images(rays, None)[0]

        return LazyRenderDataset(poses=poses, ray_fn=ray_fn, h=res, w=res,
                                 near=cfg.near, far=cfg.far)
    # train and test orbit angles interleave and never coincide
    angles = (_train_angles(n_views) if split == "train"
              else _test_angles(n_views))
    n = len(angles)
    poses = _orbit_poses_at(angles)
    rays = pinhole_rays(poses, res, res, focal, cfg.near, cfg.far)
    images = _shade_sphere(rays.origins, rays.viewdirs, background=background)
    flat_rays, flat_pix = flatten_images(rays, images)
    return RayDataset(
        rays=flat_rays, pixels=flat_pix, h=res, w=res,
        near=cfg.near, far=cfg.far, n_images=n)
