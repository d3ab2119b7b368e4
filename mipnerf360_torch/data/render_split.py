"""Synthesized-camera-path "render" split for Blender scenes (host-side
NumPy; counterpart of ``mipnerf360_tpu/data/render_split.py``).

A spiral (``render_spherify=False``) or spherical camera path at
``render_h`` x ``render_w`` and ``render_focal``, independent of the
training images, for the video renderer. LLFF and nerf_360 scenes do not
use it: their render paths are fit to the recentered training poses
(``data/llff.py``).
"""
from __future__ import annotations

import numpy as np

from ..config import DataConfig
from .base import LazyRenderDataset, flatten_images
from .pose import spherical_path, spiral_path
from .rays_gen import pinhole_rays


def render_path_dataset(cfg: DataConfig) -> LazyRenderDataset:
    """The pixel-less render split from DataConfig; rays are generated per
    pose as the video renderer asks for them."""
    if cfg.render_spherify:
        poses = spherical_path(cfg.render_radius, cfg.n_render_poses)
    else:
        radii = np.full((3,), cfg.render_radii, dtype=np.float32)
        poses = spiral_path(radii, cfg.render_focal, cfg.n_render_poses)
    cam_to_world = np.asarray(poses, dtype=np.float32)[:, :3, :4]

    h, w = cfg.render_h, cfg.render_w

    def ray_fn(p):
        rays = pinhole_rays(p, h, w, cfg.render_focal, cfg.near, cfg.far)
        return flatten_images(rays, None)[0]

    return LazyRenderDataset(poses=cam_to_world, ray_fn=ray_fn, h=h, w=w,
                             near=cfg.near, far=cfg.far)
