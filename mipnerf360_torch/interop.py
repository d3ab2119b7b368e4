"""Params between the JAX package's tree and this port.

Both keep the layout ``{"prop": {"layers": [{"w": [in, out], "b": [out]}]},
"nerf": {"trunk"|"density"|"rgb": {"layers": [...]}}}``, so the conversion is
the identity on every array. Only NumPy crosses the boundary: the JAX side
calls ``jax.tree.map(np.asarray, params)`` itself, and this module imports
no JAX.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .models.mipnerf360 import MipNeRF360, Params, map_params


def params_from_jax(tree) -> Params:
    """A tree of NumPy arrays (the JAX params) -> the same tree of float32
    CPU tensors, as ``init_model`` returns."""
    return map_params(
        lambda a: torch.tensor(np.asarray(a, dtype=np.float32)), tree)


def params_to_numpy(params) -> dict:
    """A :class:`MipNeRF360` module or a params tree -> the same tree of
    float32 NumPy arrays, as ``jax.tree.map(np.asarray, params)`` gives."""
    if isinstance(params, nn.Module):
        if not isinstance(params, MipNeRF360):
            raise TypeError(f"expected a MipNeRF360 module, got {type(params)}")
        params = params.params()
    return map_params(
        lambda t: t.detach().to("cpu", torch.float32).numpy().copy(), params)
