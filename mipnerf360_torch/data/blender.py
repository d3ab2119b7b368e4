"""Blender synthetic dataset loader (host-side NumPy; counterpart of
``mipnerf360_tpu/data/blender.py``).

Reads ``transforms_{split}.json`` and its PNGs (``utils/png.load_image``),
halves the resolution with a 2x2 box filter when factor >= 2, composites
alpha over white when the model's background is white, and takes the focal
from ``camera_angle_x``. The render split is a synthesized path
(``data/render_split.py``) that reads no images.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..config import DataConfig
from ..utils.png import load_image
from .base import RayDataset, flatten_images
from .rays_gen import pinhole_rays


def _downsample_half(img: np.ndarray) -> np.ndarray:
    """2x box-filter downsample (half resolution for any factor >= 2)."""
    h, w = (img.shape[0] // 2) * 2, (img.shape[1] // 2) * 2
    img = img[:h, :w]
    return 0.25 * (img[0::2, 0::2] + img[1::2, 0::2] +
                   img[0::2, 1::2] + img[1::2, 1::2])


def load_blender(cfg: DataConfig, split: str = "train",
                 white_bkgd: bool = True):
    if split == "render":
        from .render_split import render_path_dataset

        return render_path_dataset(cfg)

    if split == "visualize":
        split = "test"      # the held-out views, as the JAX package's alias
    base = cfg.base_dir or os.path.join("data/nerf_synthetic", cfg.scene)
    with open(os.path.join(base, f"transforms_{split}.json")) as fp:
        meta = json.load(fp)

    images, cams = [], []
    for frame in meta["frames"]:
        img = load_image(os.path.join(base, frame["file_path"] + ".png"))
        if cfg.factor >= 2:
            img = _downsample_half(img)
        images.append(img)
        cams.append(np.array(frame["transform_matrix"], dtype=np.float32))
    images = np.stack(images, 0)
    if white_bkgd and images.shape[-1] == 4:
        images = images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
    else:
        images = images[..., :3]

    h, w = images.shape[1:3]
    cam_to_world = np.stack(cams, 0)[:, :3, :4]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))

    rays = pinhole_rays(cam_to_world, h, w, focal, cfg.near, cfg.far)
    flat_rays, flat_pix = flatten_images(rays, images)
    return RayDataset(rays=flat_rays, pixels=flat_pix, h=h, w=w,
                      near=cfg.near, far=cfg.far, n_images=images.shape[0])
