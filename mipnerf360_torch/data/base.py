"""Dataset container (host-side NumPy; counterpart of
``mipnerf360_tpu/data/base.py``).

Rays for all images are generated once and flattened to [N, c] arrays, and
whole images are sliced out of them. Training batches (the native batch
sampler) and the lazy render split come with the trainer and the render
splits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..core.rays import Rays, rays_map


@dataclass
class RayDataset:
    rays: Rays                    # flattened [N, c] float32 arrays
    pixels: Optional[np.ndarray]  # [N, 3] or None (render split)
    h: int
    w: int
    near: float
    far: float
    n_images: int

    @property
    def n_rays(self) -> int:
        return self.rays.origins.shape[0]

    def image(self, i: int) -> Tuple[Rays, Optional[np.ndarray]]:
        """All rays (and pixels) of image ``i``, flattened [H*W, c]."""
        per = self.h * self.w
        sl = slice(i * per, (i + 1) * per)
        rays = rays_map(lambda x: x[sl], self.rays)
        pix = self.pixels[sl] if self.pixels is not None else None
        return rays, pix


def flatten_images(rays: Rays, images: Optional[np.ndarray]) -> Tuple[Rays, Optional[np.ndarray]]:
    """[P, H, W, c] -> [P*H*W, c]."""
    flat_rays = rays_map(lambda x: np.ascontiguousarray(
        x.reshape(-1, x.shape[-1]), dtype=np.float32), rays)
    flat_pix = None
    if images is not None:
        flat_pix = np.ascontiguousarray(
            images.reshape(-1, images.shape[-1])[:, :3], dtype=np.float32)
    return flat_rays, flat_pix
