"""Ray container used across the port (counterpart of ``mipnerf360_tpu/core/rays.py``).

``Rays`` is a NamedTuple whose fields are tensors (or, on the host side,
NumPy arrays before :func:`rays_to_device`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class Rays(NamedTuple):
    """A batch of rays; every field has leading batch dims and a trailing channel dim.

    origins:    [..., 3] ray origins (world or NDC space).
    directions: [..., 3] un-normalized ray directions (pinhole or NDC).
    viewdirs:   [..., 3] unit-norm viewing directions (world space).
    radii:      [..., 1] base radius of the cone/cylinder footprint at unit distance.
    near:       [..., 1] near plane distance.
    far:        [..., 1] far plane distance.
    """

    origins: Any
    directions: Any
    viewdirs: Any
    radii: Any
    near: Any
    far: Any


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of every
    entry point) raises when no CUDA device is present: the CPU is used only
    when the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def rays_map(fn: Callable, rays: Rays) -> Rays:
    """Apply ``fn`` to every field of a ``Rays``."""
    return Rays(*(fn(x) for x in rays))


def rays_to_device(rays: Rays, device) -> Rays:
    """Move a Rays batch (NumPy arrays or tensors) onto ``device`` as float32."""
    device = resolve_device(device)
    return rays_map(
        lambda x: torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                                  dtype=torch.float32, device=device),
        rays)


def flatten_rays(rays: Rays) -> Rays:
    """Flatten all leading dims so each field is [N, channels]."""
    return rays_map(lambda x: x.reshape(-1, x.shape[-1]), rays)


def take_rays(rays: Rays, idx) -> Rays:
    """Gather a subset of rays by integer indices along the leading axis."""
    return rays_map(lambda x: x[idx], rays)


def num_rays(rays: Rays) -> int:
    return rays.origins.shape[0]


def dummy_rays(batch: int, near: float = 2.0, far: float = 6.0, seed: int = 0) -> Rays:
    """Synthetic, well-conditioned ray batch for tests/benches (host-side NumPy;
    the same arrays as ``mipnerf360_tpu.core.rays.dummy_rays``)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(batch, 3)).astype(np.float32)
    viewdirs = d / np.linalg.norm(d, axis=-1, keepdims=True)
    origins = rng.normal(scale=0.1, size=(batch, 3)).astype(np.float32)
    radii = np.full((batch, 1), 0.0005, dtype=np.float32)
    ones = np.ones((batch, 1), dtype=np.float32)
    return Rays(
        origins=origins,
        directions=d,
        viewdirs=viewdirs.astype(np.float32),
        radii=radii,
        near=ones * near,
        far=ones * far,
    )
