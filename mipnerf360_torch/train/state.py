"""Training state and the AdamW update (counterpart of
``mipnerf360_tpu/train/state.py``).

The JAX package holds one immutable pytree ``{step, sched_count, params,
opt_state, key}``. Here :class:`TrainState` holds the same, with Python ints
for the counters and a ``torch.Generator`` in place of the PRNG key. The
update runs in place on the params and moments, which keeps one copy of
each on the card instead of two.

The optimizer is the JAX package's optax chain, written out:
``scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)``, then
``add_decayed_weights(wd)``, then ``p -= lr * u`` with the lr given on each
call. One state per subtree (``"prop"``, ``"nerf"``), each with its own
count, as there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..core.rays import resolve_device
from ..models.mipnerf360 import Params, init_model, map_params

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the update count and the first and
    second moments, trees shaped as the params subtree."""

    count: int
    mu: Any
    nu: Any


@dataclass
class TrainState:
    step: int                    # global step counter
    sched_count: int             # scheduler counter (3x/step in reference cadence)
    params: Params               # {"prop": ..., "nerf": ...}; leaves require grad
    opt_state: Dict[str, AdamState]  # {"prop": ..., "nerf": ...}
    generator: torch.Generator   # draws the randomized sampling noise


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def init_adam(params) -> AdamState:
    zeros = lambda p: torch.zeros_like(p, requires_grad=False)
    return AdamState(count=0, mu=map_params(zeros, params),
                     nu=map_params(zeros, params))


def init_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig, *,
                     generator: Optional[torch.Generator] = None,
                     device="cuda") -> TrainState:
    """Params from :func:`init_model` with ``generator`` (a CPU generator
    seeded with ``train_cfg.seed`` when None), moved to ``device``, which is
    the card unless the caller passes ``device="cpu"``; zero AdamW moments;
    and a generator on ``device`` for the sampling noise, seeded from
    ``generator``."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(train_cfg.seed)
    params = init_model(model_cfg, generator)
    seed = int(torch.randint(2**62, (1,), generator=generator))
    return make_train_state(params, device=device,
                            generator=torch.Generator(device).manual_seed(seed))


def make_train_state(params: Params, *, device, generator: torch.Generator,
                     step: int = 0, sched_count: int = 0,
                     opt_state: Optional[Dict[str, AdamState]] = None
                     ) -> TrainState:
    """A state from a params tree: leaves moved to ``device`` as float32
    leaf tensors that require grad; zero moments unless ``opt_state``."""
    params = map_params(
        lambda p: torch.as_tensor(p).detach().to(device, torch.float32)
        .clone().requires_grad_(), params)
    if opt_state is None:
        opt_state = {k: init_adam(params[k]) for k in ("prop", "nerf")}
    return TrainState(step=step, sched_count=sched_count, params=params,
                      opt_state=opt_state, generator=generator)


@torch.no_grad()
def apply_updates_subtree(params, grads, opt_state: AdamState, lr,
                          weight_decay: float) -> None:
    """One AdamW step on a params subtree, in place, in optax's order:
    moments, bias correction, ``u = mu_hat / (sqrt(nu_hat) + eps)``,
    ``u += wd * p``, ``p -= lr * u``. ``grads`` is a list in
    :func:`leaves` order."""
    opt_state.count += 1
    # optax's bias_correction computes decay**count in float32
    bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(opt_state.count))
    bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(opt_state.count))
    lr = float(lr)
    for p, g, mu, nu in zip(leaves(params), grads, leaves(opt_state.mu),
                            leaves(opt_state.nu)):
        mu.mul_(B1).add_((1 - B1) * g)
        nu.mul_(B2).add_((1 - B2) * (g * g))
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        u += weight_decay * p
        p -= lr * u
