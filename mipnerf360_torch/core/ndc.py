"""Normalized-device-coordinate ray conversion for forward-facing (LLFF)
scenes (host-side NumPy; a copy of ``mipnerf360_tpu/core/ndc.py``).

It runs once when a dataset is built, on the float32 arrays of
``data/rays_gen.py::pinhole_rays``, so that the port's NDC rays are the JAX
package's bit for bit.
"""
from __future__ import annotations

import numpy as np


def convert_to_ndc(origins, directions, focal, w, h, near: float = 1.0):
    """Shift origins to the near plane and project rays into NDC space."""
    t = -(near + origins[..., 2]) / (directions[..., 2] + 1e-15)
    origins = origins + t[..., None] * directions

    dx, dy, dz = np.moveaxis(directions, -1, 0)
    ox, oy, oz = np.moveaxis(origins, -1, 0)

    o0 = -((2.0 * focal) / w) * (ox / (oz + 1e-15))
    o1 = -((2.0 * focal) / h) * (oy / (oz + 1e-15))
    o2 = 1.0 + 2.0 * near / (oz + 1e-15)

    d0 = -((2.0 * focal) / w) * (dx / (dz + 1e-15) - ox / (oz + 1e-15))
    d1 = -((2.0 * focal) / h) * (dy / (dz + 1e-15) - oy / (oz + 1e-15))
    d2 = -2.0 * near / (oz + 1e-15)

    return np.stack([o0, o1, o2], -1), np.stack([d0, d1, d2], -1)
