"""Host-side data (counterpart of ``mipnerf360_tpu/data``): the Blender,
LLFF and nerf_360 loaders, the synthetic scene, the render splits, the
batch stream, and the eval images' visualizations."""
from __future__ import annotations

from ..config import DataConfig
from . import pose, viz
from .base import LazyRenderDataset, RayDataset, flatten_images
from .blender import load_blender
from .llff import load_llff
from .rays_gen import ndc_rays, pinhole_rays
from .synthetic import synthetic_dataset


def get_dataset(cfg: DataConfig, split: str = "train",
                white_bkgd: bool | None = None):
    """Dataset factory (counterpart of
    ``mipnerf360_tpu/data/__init__.py::get_dataset``): a RayDataset for the
    train, test and visualize splits, a LazyRenderDataset for render.

    ``white_bkgd``: the MODEL's background regime (ModelConfig.white_bkgd).
    The synthetic scene's background and the Blender alpha compositing
    follow it, so that the targets and the renderer composite empty space
    alike; None (dataset-only callers) keeps the white default. nerf_360
    scenes use the LLFF loader with a spherified render path."""
    name = cfg.dataset
    if name == "synthetic":
        return synthetic_dataset(
            cfg, split, background=0.0 if white_bkgd is False else 1.0)
    if name == "blender":
        return load_blender(cfg, split, white_bkgd=white_bkgd is not False)
    if name == "llff":
        return load_llff(cfg, split, spherify=False,
                         n_render_poses=cfg.n_render_poses)
    if name == "nerf_360":
        return load_llff(cfg, split, spherify=(split == "render"),
                         n_render_poses=cfg.n_render_poses)
    raise ValueError(f"unknown dataset {name!r}")
