"""Host-side data (counterpart of ``mipnerf360_tpu/data``): the synthetic
scene, the batch stream, and the eval images' visualizations."""
from __future__ import annotations

from ..config import DataConfig
from . import viz
from .base import RayDataset, flatten_images
from .rays_gen import pinhole_rays
from .synthetic import synthetic_dataset


def get_dataset(cfg: DataConfig, split: str = "train",
                white_bkgd: bool | None = None) -> RayDataset:
    """Dataset factory (counterpart of
    ``mipnerf360_tpu/data/__init__.py::get_dataset``).

    ``white_bkgd``: the MODEL's background regime (ModelConfig.white_bkgd).
    The synthetic scene's background follows it, so that the targets and the
    renderer composite empty space alike; None (dataset-only callers) keeps
    the white default. Only the synthetic scene is ported: the Blender and
    LLFF loaders raise ``NotImplementedError``."""
    name = cfg.dataset
    if name == "synthetic":
        return synthetic_dataset(
            cfg, split, background=0.0 if white_bkgd is False else 1.0)
    if name in ("blender", "llff", "nerf_360"):
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP queue 1 item 6: "
            "the Blender and LLFF loaders); use data.dataset=synthetic")
    raise ValueError(f"unknown dataset {name!r}")
