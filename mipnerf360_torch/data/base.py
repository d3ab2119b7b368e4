"""Dataset containers (host-side NumPy; counterpart of
``mipnerf360_tpu/data/base.py``).

``RayDataset``: rays for all images are generated once and flattened to
[N, c] arrays; training batches are gathers from the stateless index stream
of the native batcher, and eval iterates whole images. Moving batches to
the card happens in the trainer. ``LazyRenderDataset``: the pixel-less
render split, whose rays are generated one pose at a time. The ``*_local``
variants give one data rank's rows of the same stream.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from ..core.rays import Rays, rays_map


def _rows_per_rank(batch_size: int, proc_count: int) -> int:
    if batch_size % proc_count:
        raise ValueError(f"batch of {batch_size} rays does not split over "
                         f"{proc_count} data ranks")
    return batch_size // proc_count


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

    def batch_stack_local(self, k: int, batch_size: int, seed: int,
                          start_step: int, proc_index: int, proc_count: int
                          ) -> Tuple[Rays, np.ndarray]:
        """Data rank ``proc_index``'s shard of :meth:`batch_stack`: rows
        [p*B/P, (p+1)*B/P) of each of the k per-step batches, drawn from the
        same stateless counter stream, so that the P shards concatenated
        along the batch axis are :meth:`batch_stack` bit for bit. The host's
        gather scales with the rank's rows, not the global batch."""
        from ..native import fill_batch_stack

        b_loc = _rows_per_rank(batch_size, proc_count)
        arrays = list(self.rays) + [self.pixels]
        outs = [np.empty((k, b_loc, a.shape[-1]), np.float32) for a in arrays]
        for i in range(k):
            # step i's counters for rank p: a contiguous run of b_loc inside
            # the step's [B] window of the global stream
            start = (start_step + i) * batch_size + proc_index * b_loc
            rows = fill_batch_stack(seed, start, b_loc, arrays)
            for o, r in zip(outs, rows):
                o[i] = r
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

    def index_stack_local(self, k: int, batch_size: int, seed: int,
                          start_step: int, proc_index: int, proc_count: int
                          ) -> np.ndarray:
        """Data rank ``proc_index``'s [k, B/P] shard of :meth:`index_stack`
        (the counter runs of :meth:`batch_stack_local`): the P shards
        concatenated along the batch axis are the global stack bit for
        bit."""
        from ..native import sample_indices

        b_loc = _rows_per_rank(batch_size, proc_count)
        out = np.empty((k, b_loc), np.int32)
        for i in range(k):
            start = (start_step + i) * batch_size + proc_index * b_loc
            out[i] = sample_indices(seed, start, b_loc, self.n_rays)
        return out

    def image(self, i: int) -> Tuple[Rays, Optional[np.ndarray]]:
        """All rays (and pixels) of image ``i``, flattened [H*W, c]."""
        per = self.h * self.w
        sl = slice(i * per, (i + 1) * per)
        rays = rays_map(lambda x: x[sl], self.rays)
        pix = self.pixels[sl] if self.pixels is not None else None
        return rays, pix

    def images(self):
        for i in range(self.n_images):
            yield self.image(i)


@dataclass
class LazyRenderDataset:
    """Pixel-less render split that generates each pose's rays on demand.

    A materialized render split would hold every pose's rays in host memory
    at once (a 120-pose factor-4 nerf_360 render is ~5 GB of rays); the
    video renderer touches one pose at a time, so ``image(i)`` generates
    pose i's rays when asked. The ``rays`` property materializes the whole
    split, for callers that want the flat arrays.
    """
    poses: np.ndarray          # [P, 3, 4] camera-to-world
    ray_fn: Callable[[np.ndarray], Rays]   # [k, 3, 4] -> flat [k*H*W, c]
    h: int
    w: int
    near: float
    far: float
    pixels: Optional[np.ndarray] = None   # always None (no ground truth)

    @property
    def n_images(self) -> int:
        return self.poses.shape[0]

    @property
    def n_rays(self) -> int:
        return self.n_images * self.h * self.w

    @property
    def rays(self) -> Rays:
        return self.ray_fn(self.poses)

    def image(self, i: int) -> Tuple[Rays, None]:
        return self.ray_fn(self.poses[i:i + 1]), None

    def images(self):
        for i in range(self.n_images):
            yield self.image(i)


def flatten_images(rays: Rays, images: Optional[np.ndarray]) -> Tuple[Rays, Optional[np.ndarray]]:
    """[P, H, W, c] -> [P*H*W, c]."""
    flat_rays = rays_map(lambda x: np.ascontiguousarray(
        x.reshape(-1, x.shape[-1]), dtype=np.float32), rays)
    flat_pix = None
    if images is not None:
        flat_pix = np.ascontiguousarray(
            images.reshape(-1, images.shape[-1])[:, :3], dtype=np.float32)
    return flat_rays, flat_pix
