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

:func:`state_dict` and :func:`load_state_dict` give the state as one tree
for checkpoints (``train/checkpoint.py``), generator state included.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..core.rays import resolve_device
from ..models.mipnerf360 import Params, init_model, map_params
from ..utils.trace import span

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
    generator: Optional[torch.Generator]  # draws the sampling noise; None in eval


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


def state_dict(state: TrainState) -> dict:
    """The whole state as a tree of ints, strs and tensors (what
    ``torch.save`` writes and ``torch.load(..., weights_only=True)`` reads):
    the counters, the params, each subtree's Adam ``count``, ``mu`` and
    ``nu``, and the generator's state with its device type, so that a
    resumed run draws the same noise as a straight one. The tensors are
    detached views of the live ones; a caller that lets the state step on
    copies them first."""
    detach = lambda t: t.detach()
    return {
        "step": int(state.step),
        "sched_count": int(state.sched_count),
        "params": map_params(detach, state.params),
        "opt_state": {k: {"count": int(a.count), "mu": map_params(detach, a.mu),
                          "nu": map_params(detach, a.nu)}
                      for k, a in state.opt_state.items()},
        "generator": {"device": state.generator.device.type,
                      "state": state.generator.get_state()},
    }


def _copy_tree(dst, src, path: str) -> None:
    """Copy ``src`` into ``dst`` leaf by leaf, in place; the nesting, keys,
    lengths and shapes must match."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise ValueError(f"{path}: expected keys {sorted(dst)}")
        for k in dst:
            _copy_tree(dst[k], src[k], f"{path}.{k}")
    elif isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(src) != len(dst):
            raise ValueError(f"{path}: expected a sequence of {len(dst)}")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_tree(d, s, f"{path}.{i}")
    else:
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: shape {tuple(src.shape)} does not "
                             f"match {tuple(dst.shape)}")
        dst.copy_(src)


@torch.no_grad()
def load_state_dict(state: TrainState, sd: dict) -> TrainState:
    """Load :func:`state_dict` output into ``state`` in place (params and
    moments keep their tensors and device) and return it. The generator is
    restored on the device type it was saved from: loading a card
    generator's state into a CPU generator, or the reverse, raises. A state
    whose generator is None (one that draws no noise, as the eval's) takes
    no generator state."""
    gen, saved = state.generator, sd["generator"]["device"]
    if gen is not None and saved != gen.device.type:
        raise ValueError(
            f"the checkpoint's generator was saved on {saved!r}; it cannot "
            f"be restored into a generator on {gen.device.type!r}"
            " (train on the device the checkpoint was written from)")
    _copy_tree(state.params, sd["params"], "params")
    for k, a in state.opt_state.items():
        _copy_tree(a.mu, sd["opt_state"][k]["mu"], f"opt_state.{k}.mu")
        _copy_tree(a.nu, sd["opt_state"][k]["nu"], f"opt_state.{k}.nu")
        a.count = int(sd["opt_state"][k]["count"])
    state.step = int(sd["step"])
    state.sched_count = int(sd["sched_count"])
    if gen is not None:
        gen.set_state(sd["generator"]["state"].cpu())
    return state


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
    with span("step.adamw"):
        for p, g, mu, nu in zip(leaves(params), grads, leaves(opt_state.mu),
                                leaves(opt_state.nu)):
            mu.mul_(B1).add_((1 - B1) * g)
            nu.mul_(B2).add_((1 - B2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            u += weight_decay * p
            p -= lr * u
