"""Pinhole ray generation (host-side NumPy; counterpart of
``mipnerf360_tpu/data/rays_gen.py``). NDC rays come with the LLFF loader."""
from __future__ import annotations

import numpy as np

from ..core.rays import Rays


def pinhole_rays(cam_to_world, h: int, w: int, focal: float,
                 near: float, far: float) -> Rays:
    """Rays for a stack of pinhole cameras.

    cam_to_world: [P, 3, 4]. Returns Rays of NumPy arrays with fields
    [P, H, W, c]. The pixel-footprint radius is the x-neighbor direction
    distance scaled by 2/sqrt(12).
    """
    x, y = np.meshgrid(
        np.arange(w, dtype=np.float32),
        np.arange(h, dtype=np.float32),
        indexing="xy")
    camera_dirs = np.stack(
        [(x - w * 0.5 + 0.5) / focal,
         -(y - h * 0.5 + 0.5) / focal,
         -np.ones_like(x)],
        axis=-1)
    directions = (camera_dirs[None, ..., None, :] *
                  cam_to_world[:, None, None, :3, :3]).sum(axis=-1)
    origins = np.broadcast_to(
        cam_to_world[:, None, None, :3, -1], directions.shape)
    viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)

    dx = np.sqrt(np.sum((directions[:, :-1] - directions[:, 1:]) ** 2, -1))
    dx = np.concatenate([dx, dx[:, -2:-1, :]], 1)
    radii = dx[..., None] * 2.0 / np.sqrt(12.0)

    ones = np.ones_like(origins[..., :1])
    return Rays(
        origins=origins.astype(np.float32),
        directions=directions.astype(np.float32),
        viewdirs=viewdirs.astype(np.float32),
        radii=radii.astype(np.float32),
        near=(ones * near).astype(np.float32),
        far=(ones * far).astype(np.float32),
    )
