"""LLFF / nerf_360 dataset loader (host-side NumPy; counterpart of
``mipnerf360_tpu/data/llff.py``).

Reads ``images_{factor}/`` (or ``images/`` at factor 1) and
``poses_bounds.npy``, swaps the pose axes and rescales, recenters, holds
out every 8th frame for test, and generates NDC rays with x/y-neighbour
footprint radii (``use_ndc``) or metric rays with near/far from the depth
bounds. The render split is a spiral path (forward-facing scenes) or a
spherified orbit (nerf_360), generated one pose at a time. nerf_360 scenes
use this loader; their unbounded handling lives in ``contract()``.
"""
from __future__ import annotations

import os

import numpy as np

from ..config import DataConfig
from ..utils.png import load_image
from .base import LazyRenderDataset, RayDataset, flatten_images
from .pose import look_at, normalize, poses_avg, recenter_poses
from .rays_gen import ndc_rays, pinhole_rays


def _load_images(img_dir: str) -> np.ndarray:
    files = sorted(
        os.path.join(img_dir, f) for f in os.listdir(img_dir)
        if f.lower().endswith(("jpg", "jpeg", "png")))
    return np.stack([load_image(f) for f in files], 0)


def _load_poses(base_dir: str, factor: int, img_shape):
    poses_arr = np.load(os.path.join(base_dir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])
    # the loaded images' h/w, and the focal scaled to them
    poses[:2, 4, :] = np.array(img_shape[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] / factor
    # rotation-column reorder: [down, right, back] -> [right, up, back]
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)
    scale = 1.0 / (bds.min() * 0.75)
    poses[:, :3, 3] *= scale
    bds *= scale
    return recenter_poses(poses), bds


def _spherify_render_poses(poses, bds, n_poses: int,
                           world_frame: bool = False):
    """360-degree render path around the central axis.

    ``world_frame=False`` returns the orbit in the spherify "reset" frame
    (rotated so that the central axis is z, translations scaled by 1/rad),
    which is not the frame of the recentered training poses: the reference
    behaviour, hidden by its NDC near=0/far=1 rays. ``world_frame=True``
    (metric rays, near/far from the unscaled ``bds``) maps the orbit back
    into the training frame, so that the render cameras orbit the learned
    scene at the training cameras' radius."""
    p34_to_44 = lambda p: np.concatenate(
        [p, np.tile(np.reshape(np.eye(4)[-1], [1, 1, 4]), [p.shape[0], 1, 1])], 1)
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    a_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -a_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(a_i, [0, 2, 1]) @ a_i).mean(0)) @ b_i.mean(0))

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)
    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    poses_reset[:, :3, 3] *= 1.0 / rad
    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(max(1.0 - zh**2, 1e-6))

    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, n_poses):
        cam_origin = np.array(
            [radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = normalize(cam_origin)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, cam_origin], 1))
    new_poses = np.stack(new_poses, 0)
    if world_frame:
        new_poses = new_poses.copy()
        new_poses[:, :3, 3] *= rad                      # undo 1/rad scale
        new_poses = (p34_to_44(c2w[None]) @ p34_to_44(new_poses))[:, :3, :4]
    return np.concatenate(
        [new_poses,
         np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)], -1)


def _spiral_render_poses(poses, bds, n_poses: int):
    """Spiral render path for forward-facing scenes."""
    c2w = poses_avg(poses)
    up = normalize(poses[:, :3, 1].sum(0))
    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    tt = poses[:, :3, 3]
    rads = np.percentile(np.abs(tt), 90, 0)
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    zrate = 0.5
    render_poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * 2, n_poses + 1)[:-1]:
        c = np.dot(c2w[:3, :4], np.array(
            [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads)
        z = normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([look_at(z, up, c), hwf], 1))
    return np.array(render_poses, dtype=np.float32)


def load_llff(cfg: DataConfig, split: str = "train", spherify: bool = False,
              n_render_poses: int = 120):
    base = cfg.base_dir or os.path.join("data/nerf_llff_data", cfg.scene)
    img_dir = os.path.join(
        base, "images" if cfg.factor == 1 else f"images_{cfg.factor}")
    images = _load_images(img_dir)
    poses, bds = _load_poses(base, cfg.factor, images.shape[1:3])
    h, w = images.shape[1:3]

    if split == "render":
        if spherify:
            render = _spherify_render_poses(poses, bds, n_render_poses,
                                            world_frame=not cfg.use_ndc)
        else:
            render = _spiral_render_poses(poses, bds, n_render_poses)
        cam_to_world = np.ascontiguousarray(
            render[:, :3, :4], dtype=np.float32)
        focal = float(poses[0, -1, -1])
        if cfg.use_ndc:
            near, far = cfg.near, cfg.far

            def ray_fn(p):
                r = pinhole_rays(p, h, w, focal, near, far)
                r = ndc_rays(r, focal, w, h, near, far)
                return flatten_images(r, None)[0]
        else:
            near = float(bds.min() * 0.9)
            far = float(bds.max())

            def ray_fn(p):
                r = pinhole_rays(p, h, w, focal, near, far)
                return flatten_images(r, None)[0]

        return LazyRenderDataset(poses=cam_to_world, ray_fn=ray_fn, h=h, w=w,
                                 near=near, far=far)

    all_idx = np.arange(images.shape[0])
    test_idx = all_idx[::8]     # every 8th frame is held out
    idx = test_idx if split in ("test", "visualize") else np.array(
        [i for i in all_idx if i not in test_idx])
    images = images[idx]
    poses = poses[idx]
    cam_to_world = poses[:, :3, :4]
    focal = poses[0, -1, -1]
    n_images = images.shape[0]

    if cfg.use_ndc:
        # NDC with cfg.near/far as the NDC bounds (the reference's 0 and 1)
        near, far = cfg.near, cfg.far
        rays = pinhole_rays(cam_to_world, h, w, float(focal), near, far)
        rays = ndc_rays(rays, float(focal), w, h, near, far)
    else:
        # Metric rays, near/far from the scene's depth bounds: the s-spacing
        # sampler and contract() handle the unbounded far field.
        near = float(bds.min() * 0.9)
        far = float(bds.max())
        rays = pinhole_rays(cam_to_world, h, w, float(focal), near, far)
    flat_rays, flat_pix = flatten_images(rays, images)
    return RayDataset(rays=flat_rays, pixels=flat_pix, h=h, w=w,
                      near=near, far=far, n_images=n_images)
