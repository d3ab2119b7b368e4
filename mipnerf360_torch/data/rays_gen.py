"""Pinhole and NDC ray generation (host-side NumPy; counterpart of
``mipnerf360_tpu/data/rays_gen.py``). Runs once when a dataset is built."""
from __future__ import annotations

import numpy as np

from ..core.ndc import convert_to_ndc
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


def ndc_rays(rays: Rays, focal: float, w: int, h: int,
             near: float, far: float) -> Rays:
    """Project [P, H, W, c] pinhole rays into NDC and recompute the
    footprint radii from both the x and the y neighbours."""
    o, d = convert_to_ndc(rays.origins, rays.directions, focal, w, h)
    dx = np.sqrt(np.sum((o[:, :-1] - o[:, 1:]) ** 2, -1))
    dx = np.concatenate([dx, dx[:, -2:-1, :]], 1)
    dy = np.sqrt(np.sum((o[:, :, :-1] - o[:, :, 1:]) ** 2, -1))
    dy = np.concatenate([dy, dy[:, :, -2:-1]], 2)
    radii = (0.5 * (dx + dy))[..., None] * 2.0 / np.sqrt(12.0)
    ones = np.ones_like(o[..., :1])
    return Rays(
        origins=o.astype(np.float32),
        directions=d.astype(np.float32),
        viewdirs=rays.viewdirs,
        radii=radii.astype(np.float32),
        near=(ones * near).astype(np.float32),
        far=(ones * far).astype(np.float32),
    )
