"""Pose utilities (host-side NumPy; counterpart of ``mipnerf360_tpu/data/pose.py``).

Only what the synthetic scene needs so far; the render-path synthesis
(``spherical_path``, ``spiral_path``) and pose recentering come with the
render splits.
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
