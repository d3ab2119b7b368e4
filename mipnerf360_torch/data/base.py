"""Dataset container (host-side NumPy; counterpart of
``mipnerf360_tpu/data/base.py``).

Rays for all images are generated once and flattened to [N, c] arrays;
training batches are gathers from the stateless index stream of the native
batcher, and eval iterates whole images. Moving batches to the card happens
in the trainer. The process-local ``*_local`` variants and the lazy render
split come with the parallel and data slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

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

    def batches(self, batch_size: int, seed: int = 0
                ) -> Iterator[Tuple[Rays, np.ndarray]]:
        """Infinite stream of uniformly sampled ray batches (the reference's
        shuffling DataLoader + cycle()); the trainer's ``eval_every`` batches."""
        rng = np.random.default_rng(seed)
        n = self.n_rays
        while True:
            idx = rng.integers(0, n, size=(batch_size,))
            yield rays_map(lambda x: x[idx], self.rays), self.pixels[idx]

    def batch_stack(self, k: int, batch_size: int, seed: int, start_step: int
                    ) -> Tuple[Rays, np.ndarray]:
        """K per-step batches as one [K, B, c] stack, sampled and gathered by
        the native batcher. The index stream is stateless in (seed, global
        ray counter), so data order is resume-deterministic and independent
        of the dispatch chunking."""
        from ..native import fill_batch_stack

        total = k * batch_size
        arrays = list(self.rays) + [self.pixels]
        outs = fill_batch_stack(seed, start_step * batch_size, total, arrays)
        outs = [o.reshape(k, batch_size, o.shape[-1]) for o in outs]
        return Rays(*outs[:-1]), outs[-1]

    def index_stack(self, k: int, batch_size: int, seed: int, start_step: int
                    ) -> np.ndarray:
        """[k, B] int32 ray indices of the SAME stateless stream that
        :meth:`batch_stack` gathers, for staging from a bank held on the card
        (``train/step.py::make_banked_train_loop``): only these indices cross
        to the card."""
        from ..native import sample_indices

        idx = sample_indices(seed, start_step * batch_size, k * batch_size,
                             self.n_rays)
        return idx.reshape(k, batch_size).astype(np.int32)

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
