"""Camera-path synthesis and pose utilities (host-side NumPy; a copy of
``mipnerf360_tpu/data/pose.py``): spiral and spherical render paths, pose
recentering and averaging, look-at construction.
"""
from __future__ import annotations

import numpy as np


def normalize(x):
    return x / np.linalg.norm(x)


def look_at(z, up, pos):
    """3x4 camera-to-world from forward axis, up hint and position."""
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses):
    """Average pose of an [N, 3, 5] pose array."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([look_at(vec2, up, center), hwf], 1)


def recenter_poses(poses):
    """Transform all poses into the average-pose frame."""
    poses_ = poses.copy()
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    poses_h = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses_h = np.linalg.inv(c2w) @ poses_h
    poses_[:, :3, :4] = poses_h[:, :3, :4]
    return poses_


def spiral_path(radii, focus_depth, n_poses: int = 120):
    """Spiral camera path for forward-facing scenes.

    radii: (3,) spiral radii; returns [n_poses, 3, 4] cam-to-world.
    """
    cams = []
    for t in np.linspace(0, 4 * np.pi, n_poses + 1)[:-1]:
        center = np.array([
            (np.cos(t) * 0.5) - 2.0,
            -np.sin(t) - 0.5,
            -np.sin(0.5 * t) * 0.75,
        ]) * radii
        z = normalize(center - np.array([0, 0, -focus_depth]))
        x = normalize(np.cross(np.array([0.0, 1.0, 0.0]), z))
        y = np.cross(z, x)
        cams.append(np.stack([y, z, x, center], 1))
    return np.stack(cams, 0)


def spherical_path(radius, n_poses: int = 120, phi_deg: float = -30.0):
    """Circular path around the z axis at elevation phi."""

    def pose(theta, phi, radius):
        trans = np.array(
            [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, radius], [0, 0, 0, 1]],
            dtype=np.float32)
        rot_phi = np.array(
            [[1, 0, 0, 0],
             [0, np.cos(phi), -np.sin(phi), 0],
             [0, np.sin(phi), np.cos(phi), 0],
             [0, 0, 0, 1]], dtype=np.float32)
        rot_theta = np.array(
            [[np.cos(theta), 0, -np.sin(theta), 0],
             [0, 1, 0, 0],
             [np.sin(theta), 0, np.cos(theta), 0],
             [0, 0, 0, 1]], dtype=np.float32)
        c2w = rot_theta @ rot_phi @ trans
        flip = np.array(
            [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
            dtype=np.float32)
        return flip @ c2w

    phi = phi_deg / 180.0 * np.pi
    return np.stack(
        [pose(th, phi, radius) for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]],
        0)
