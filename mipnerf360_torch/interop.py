"""Params and train state between the JAX package's trees and this port.

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

from .core.rays import resolve_device
from .models.mipnerf360 import MipNeRF360, Params, map_params
from .train.state import AdamState, TrainState, make_train_state


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


def _adam_state(chain_state):
    """The ``ScaleByAdamState(count, mu, nu)`` of an optax chain's state (a
    tuple of per-transform states)."""
    for s in chain_state:
        if all(hasattr(s, a) for a in ("count", "mu", "nu")):
            return s
    raise ValueError("no ScaleByAdamState (count, mu, nu) in the optimizer "
                     f"state {type(chain_state).__name__}")


def train_state_from_jax(tree, *, device="cuda",
                         generator: torch.Generator = None) -> TrainState:
    """A JAX ``TrainState`` as NumPy arrays (``jax.tree.map(np.asarray,
    state)``) -> the port's :class:`TrainState` on ``device`` (the card
    unless the caller passes ``device="cpu"``), so that a JAX run can be
    continued here: params, ``step``, ``sched_count``, and each subtree's
    Adam count and moments.

    The PRNG key does not carry over: ``jax.random`` and ``torch`` draw
    different numbers. The state's generator is ``generator``, or a new one
    on ``device`` seeded with 0; pass explicit noise to a step to continue
    on the JAX draws.
    """
    device = resolve_device(device)
    params = params_from_jax(tree.params)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    state = make_train_state(params, device=device, generator=generator,
                             step=int(tree.step),
                             sched_count=int(tree.sched_count))

    def to_device(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    for k in ("prop", "nerf"):
        adam = _adam_state(tree.opt_state[k])
        state.opt_state[k] = AdamState(count=int(adam.count),
                                       mu=map_params(to_device, adam.mu),
                                       nu=map_params(to_device, adam.nu))
    return state
