"""The train step, both update cadences (counterpart of
``mipnerf360_tpu/train/step.py``).

- ``"joint"`` (default): one fused update per step: photometric + distortion
  into the NeRF subtree, distillation into the proposal subtree, one forward
  of each level.
- ``"reference"``: the reference's 2+1 structure, ``prop_inner_steps``
  proposal updates then one NeRF update, the scheduler advanced once per
  update. Each phase updates only the subtree whose loss it computed.

Loss split:
  prop phase:  L_prop(stop_grad(nerf t, w) -> bounds, prop w), summed over
               the proposal rounds
  nerf phase:  (30 - PSNR) + dist_loss_weight * distortion

Where the JAX package splits its PRNG key, a step here takes explicit
``noise`` (the uniforms of each forward, as :class:`RenderNoise`) or, when
it is None, draws them from ``state.generator``. The step updates the
state's params and moments in place and returns the state with its counters
advanced, and the aux dict of 0-d tensors (detached). ``make_train_loop``
and ``make_banked_train_loop`` run K steps per call, as the trainer does.

On a ``mesh`` (``parallel/mesh.py``) each rank takes its rows of the global
batch and computes the step the JAX package computes over the whole mesh:

- the losses, and the logged values, are the global batch's, from
  per-rank statistics summed over the data axis (``losses/``);
- each rank draws the noise of the global batch from the generator every
  rank holds alike, and keeps its own rows, so any number of ranks draws
  what one process draws;
- the gradients are summed (not averaged) over the data axis, through one
  flat buffer per update, before AdamW;
- with a model axis, the NeRF trunk is this rank's tensor-parallel shard,
  and so are its moments.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..config import Config
from ..core.rays import Rays, rays_map
from ..losses.distillation import distillation_loss
from ..losses.distortion import distortion_loss
from ..losses.photometric import photometric_loss
from ..models.mipnerf360 import (RenderNoise, draw_render_noise, map_params,
                                 pattern_intervals, render_rays)
from ..parallel.collectives import flat_all_reduce
from ..utils.trace import span
from .schedule import log_lerp_lr
from .state import TrainState, apply_updates_subtree, leaves

Aux = Dict[str, torch.Tensor]


def _lr(train_cfg, count):
    horizon = train_cfg.lr_max_steps or train_cfg.max_steps
    return log_lerp_lr(
        count, train_cfg.lr_init, train_cfg.lr_final, horizon,
        train_cfg.lr_delay_steps, train_cfg.lr_delay_mult)


def _groups(mesh):
    """(data group, tensor-parallel group) of ``mesh``; None for no mesh."""
    return (None, None) if mesh is None else (mesh.data_group,
                                              mesh.model_group)


def _step_noise(model_cfg, state, rays, noise, randomized, mesh):
    """``noise`` as given; on a mesh, when it is None, this rank's rows of
    the noise of the global batch, drawn from ``state.generator``."""
    if noise is not None or mesh is None or not randomized:
        return noise
    b = rays.origins.shape[0]
    full = draw_render_noise(state.generator, b * mesh.data,
                             model_cfg.num_samples, rays.origins.device,
                             model_cfg.proposal_rounds, model_cfg.nerf_samples,
                             pattern_intervals(model_cfg))
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    return RenderNoise(*(None if x is None else x[rows] for x in full))


def _sum_grads(grads, mesh):
    """Gradients summed over the data axis (one collective), or as given."""
    return list(grads) if mesh is None else flat_all_reduce(grads,
                                                            mesh.data_group)


def _distillation(train_cfg, out, data_shards, group):
    """The distillation loss of every proposal round against the NeRF
    level's weights, summed over the rounds."""
    t, w = out["t_vals"].detach(), out["weights"].detach()
    loss = None
    for t_prop, w_prop in out["props"]:
        term = distillation_loss(t, w, t_prop, w_prop,
                                 collapsed=train_cfg.quirk_collapsed_bounds,
                                 data_shards=data_shards, group=group)
        loss = term if loss is None else loss + term
    return loss


def _nerf_losses(train_cfg, out, pixels, group=None):
    loss_nerf, psnr = photometric_loss(out["rgb"], pixels, group)
    loss_dist = distortion_loss(out["s_vals"], out["weights"],
                                train_cfg.dist_loss_reduction, group)
    return loss_nerf + train_cfg.dist_loss_weight * loss_dist, {
        "psnr": psnr, "loss_nerf": loss_nerf, "loss_dist": loss_dist}


def _prop_phase(state: TrainState, model_cfg, train_cfg, rays,
                noise: Optional[RenderNoise], sched_count, randomized,
                data_shards=1, mesh=None):
    """One proposal-distillation update; the NeRF subtree is held fixed."""
    group, tp_group = _groups(mesh)
    noise = _step_noise(model_cfg, state, rays, noise, randomized, mesh)
    p = {"prop": state.params["prop"],
         "nerf": map_params(torch.Tensor.detach, state.params["nerf"])}
    out = render_rays(p, model_cfg, rays, randomized, noise=noise,
                      generator=state.generator, tp_group=tp_group)
    with span("step.losses"):
        loss = _distillation(train_cfg, out, data_shards, group)
    grads = _sum_grads(torch.autograd.grad(loss, leaves(state.params["prop"])),
                       mesh)
    apply_updates_subtree(state.params["prop"], grads, state.opt_state["prop"],
                          _lr(train_cfg, sched_count), train_cfg.weight_decay)
    return loss.detach()


def _nerf_phase(state: TrainState, model_cfg, train_cfg, rays, pixels,
                noise: Optional[RenderNoise], sched_count, randomized,
                mesh=None) -> Aux:
    """One photometric + distortion update; the proposal subtree is held
    fixed, and its samples and weights are under stop-gradient."""
    group, tp_group = _groups(mesh)
    noise = _step_noise(model_cfg, state, rays, noise, randomized, mesh)
    p = {"prop": map_params(torch.Tensor.detach, state.params["prop"]),
         "nerf": state.params["nerf"]}
    out = render_rays(p, model_cfg, rays, randomized, noise=noise,
                      generator=state.generator, tp_group=tp_group)
    with span("step.losses"):
        loss, aux = _nerf_losses(train_cfg, out, pixels, group)
    grads = _sum_grads(torch.autograd.grad(loss, leaves(state.params["nerf"])),
                       mesh)
    lr = _lr(train_cfg, sched_count)
    apply_updates_subtree(state.params["nerf"], grads, state.opt_state["nerf"],
                          lr, train_cfg.weight_decay)
    aux = {k: v.detach() for k, v in aux.items()}
    aux["loss"] = loss.detach()
    aux["lr"] = lr
    return aux


def reference_cadence_step(cfg: Config, state: TrainState, rays: Rays, pixels,
                           *, noise: Optional[Sequence[RenderNoise]] = None,
                           data_shards: int = 1, mesh=None
                           ) -> Tuple[TrainState, Aux]:
    """``prop_inner_steps`` proposal updates + 1 NeRF update; the scheduler
    advances once per update. ``noise``, when given, holds one
    :class:`RenderNoise` per update, in order (this rank's rows on a
    ``mesh``)."""
    randomized = cfg.train.randomized
    n_prop = cfg.train.prop_inner_steps
    if n_prop < 1:
        raise ValueError(
            "train.cadence='reference' is the 2+1 update structure "
            "(train.py:51-82) and needs train.prop_inner_steps >= 1; use "
            "cadence='joint' to train without separate proposal updates "
            f"(got prop_inner_steps={n_prop})")
    if noise is not None and len(noise) != n_prop + 1:
        raise ValueError(f"noise must hold {n_prop + 1} RenderNoise, "
                         f"got {len(noise)}")
    phase_noise = list(noise) if noise is not None else [None] * (n_prop + 1)
    sched = state.sched_count
    loss_prop = None
    for i in range(n_prop):
        loss_prop = _prop_phase(state, cfg.model, cfg.train, rays,
                                phase_noise[i], sched, randomized, data_shards,
                                mesh)
        sched += 1
    aux = _nerf_phase(state, cfg.model, cfg.train, rays, pixels,
                      phase_noise[-1], sched, randomized, mesh)
    aux["loss_prop"] = loss_prop
    state.step += 1
    state.sched_count = sched + 1
    return state, aux


def joint_cadence_grads(cfg: Config, state: TrainState, rays: Rays, pixels,
                        *, noise: Optional[RenderNoise] = None,
                        data_shards: int = 1, mesh=None
                        ) -> Tuple[Dict[str, list], Aux]:
    """The joint cadence's forward and backward without the update: the
    gradients, as ``{"prop": [...], "nerf": [...]}`` in :func:`leaves`
    order (on a ``mesh``, summed over the data axis: the global batch's),
    and the aux losses."""
    params = state.params
    group, tp_group = _groups(mesh)
    randomized = cfg.train.randomized
    noise = _step_noise(cfg.model, state, rays, noise, randomized, mesh)
    out = render_rays(params, cfg.model, rays, randomized, noise=noise,
                      generator=state.generator, tp_group=tp_group)
    with span("step.losses"):
        loss, aux = _nerf_losses(cfg.train, out, pixels, group)
        loss_prop = _distillation(cfg.train, out, data_shards, group)
        loss = loss + loss_prop
    prop, nerf = leaves(params["prop"]), leaves(params["nerf"])
    grads = _sum_grads(torch.autograd.grad(loss, prop + nerf), mesh)
    aux = {k: v.detach() for k, v in aux.items()}
    aux["loss_prop"] = loss_prop.detach()
    aux["loss"] = loss.detach()
    return {"prop": list(grads[:len(prop)]), "nerf": list(grads[len(prop):])}, aux


def joint_cadence_step(cfg: Config, state: TrainState, rays: Rays, pixels, *,
                       noise: Optional[RenderNoise] = None,
                       data_shards: int = 1, mesh=None
                       ) -> Tuple[TrainState, Aux]:
    """One fused update of both subtrees (the paper's cadence)."""
    grads, aux = joint_cadence_grads(cfg, state, rays, pixels, noise=noise,
                                     data_shards=data_shards, mesh=mesh)
    lr = _lr(cfg.train, state.sched_count)
    for k in ("prop", "nerf"):
        apply_updates_subtree(state.params[k], grads[k], state.opt_state[k],
                              lr, cfg.train.weight_decay)
    aux["lr"] = lr
    state.step += 1
    state.sched_count += 1
    return state, aux


def make_train_step(cfg: Config, data_shards: int = 1, mesh=None):
    """The step function of the configured cadence:
    ``step(state, rays, pixels, *, noise=None) -> (state, aux)``; on
    ``mesh``, rays and pixels are this rank's rows of the batch."""
    fn = (reference_cadence_step if cfg.train.cadence == "reference"
          else joint_cadence_step)
    return functools.partial(fn, cfg, data_shards=data_shards, mesh=mesh)


def _stack(auxes) -> Aux:
    """Per-step aux dicts -> one dict of [K] tensors, each on the device its
    values are on (the lr stays on the CPU): no host sync."""
    return {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}


def make_train_loop(cfg: Config, data_shards: int = 1, mesh=None):
    """K train steps of the configured cadence in a Python loop:
    ``loop(state, rays_stack, pixels_stack)``, where every field of the rays
    and the pixels have a leading [K] axis (one entry per step). Returns the
    state and the per-step aux dict stacked to [K].

    The counterpart of the JAX package's scanned loop. Nothing in it syncs
    with the host, so the host queues the K steps ahead of the card; the
    caller reads the stacked aux once per chunk. ``noise``, when given,
    holds each step's ``noise`` argument, in order (the tests pass the
    uniforms the JAX package draws)."""
    step = make_train_step(cfg, data_shards, mesh)

    def loop(state, rays_stack, pixels_stack, noise=None):
        auxes = []
        for i in range(pixels_stack.shape[0]):
            state, aux = step(state, rays_map(lambda x: x[i], rays_stack),
                              pixels_stack[i],
                              noise=None if noise is None else noise[i])
            auxes.append(aux)
        return state, _stack(auxes)

    return loop


def make_banked_train_loop(cfg: Config, data_shards: int = 1, mesh=None):
    """K train steps that gather each step's batch on the device from a bank
    held there: ``loop(state, bank_rays, bank_pixels, idx_stack)``.

    The bank (every flattened ray and pixel row of the train split) is
    uploaded once per run; per chunk only a [K, B] int32 index stack crosses
    to the device, and is widened to int64 there. Batch selection is
    bit-identical to host staging (``RayDataset.index_stack`` is the stream
    ``batch_stack`` gathers), so the two loops give the same results. On
    ``mesh`` the bank is whole on every rank and the index stack holds this
    rank's rows (``RayDataset.index_stack_local``)."""
    step = make_train_step(cfg, data_shards, mesh)

    def loop(state, bank_rays, bank_pixels, idx_stack):
        idx_stack = idx_stack.long()
        auxes = []
        for idx in idx_stack:
            rays = rays_map(lambda x: x.index_select(0, idx), bank_rays)
            state, aux = step(state, rays, bank_pixels.index_select(0, idx))
            auxes.append(aux)
        return state, _stack(auxes)

    return loop
