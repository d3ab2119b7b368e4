"""The (data, model) mesh over a ``torch.distributed`` process group
(counterpart of ``mipnerf360_tpu/parallel/mesh.py``).

The JAX package runs one controller over a mesh of devices and lets XLA
place the collectives. The port runs one process per device ("rank"), and
each rank computes its part of the global step itself:

- "data": ray-batch data parallelism, the primary axis. Rank r of the data
  axis keeps rows [r*B/P, (r+1)*B/P) of each global batch; params are
  replicated; the losses are computed over the global batch from summed
  per-rank statistics and the gradients are summed (``train/step.py``).
- "model": tensor parallelism of the NeRF trunk (even layers split their
  columns, odd layers their rows: ``models/mlp.py``), or, in
  ``render_image`` with ``ModelConfig.sample_shards > 1``, the samples of
  each ray (``parallel/sample_axis.py``).

Ranks are laid out as JAX lays out devices: rank = data_index * model +
model_index. The process group comes from the ``torchrun`` environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``)
or from an explicit ``init_method``: NCCL on the card, gloo on the CPU, one
device per rank. Nothing falls back to one process: a missing card, a
missing environment or a failed ``init_process_group`` raises.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..core.rays import Rays, rays_map, rays_to_device, resolve_device
from .collectives import all_reduce_, flat_broadcast_, gather_cat

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device="cuda", *, backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``device`` "cuda" (the default) becomes ``cuda:LOCAL_RANK`` and the
    backend NCCL; "cpu" takes gloo. ``backend`` overrides that choice (gloo
    over CUDA tensors lets several ranks share one card). Without
    ``init_method`` the ``torchrun`` environment must be set; with it,
    ``rank`` and ``world_size`` are given here (the tests rendezvous
    through a ``file://`` path)."""
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    if init_method is None:
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"no process group to join: {', '.join(missing)} not set "
                "(launch under torchrun, or pass init_method, rank and "
                "world_size)")
        init_method = "env://"
    else:
        kwargs = dict(rank=rank, world_size=world_size)
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend=backend, init_method=init_method, **kwargs)
    return device


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _AXIS_GROUPS.clear()


def is_primary() -> bool:
    """True on global rank 0, and in a process without a process group: the
    rank that writes logs, configs and checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def rank_device(device) -> torch.device:
    """``device`` for this rank: a bare "cuda" is the card that
    :func:`init_distributed` selected."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on the (data, model) mesh. ``data_group`` holds the
    ranks that share this rank's model coordinate (they split the batch),
    ``model_group`` those that share its data coordinate (they split the
    trunk or the samples; None when ``model`` is 1)."""

    data: int
    model: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any
    device: torch.device

    def barrier(self) -> None:
        """Wait for every rank (an all_reduce of one element on the mesh's
        device, which both backends take)."""
        all_reduce_(torch.zeros(1, device=self.device), None)


# The axis subgroups of each (data, model) layout, built once per process
# group: a Mesh is rebuilt per call (render_image, the evals), its NCCL
# communicators are not. {(data, model): (WORLD, data_group, model_group)}.
_AXIS_GROUPS: dict = {}


def _axis_groups(world: int, data: int, model: int):
    """(data_group, model_group) of the (data, model) layout, made on the
    first call for the current process group and reused after it."""
    hit = _AXIS_GROUPS.get((data, model))
    if hit is not None and hit[0] is dist.group.WORLD:
        return hit[1:]
    if model == 1:
        groups = dist.group.WORLD, None
    else:
        data_group, _ = dist.new_subgroups_by_enumeration(
            [list(range(j, world, model)) for j in range(model)])
        groups = data_group, (dist.group.WORLD if data == 1 else
                              dist.new_subgroups_by_enumeration(
                                  [list(range(i * model, (i + 1) * model))
                                   for i in range(data)])[0])
    _AXIS_GROUPS[(data, model)] = (dist.group.WORLD, *groups)
    return groups


def make_mesh(data: int = -1, model: int = 1, device=None) -> Mesh:
    """The ("data", "model") mesh over the process group. ``data = -1``
    resolves to ``world_size // model``; ``data * model`` must equal the
    world size. ``device`` defaults to this rank's card under NCCL; under
    gloo, which serves both the CPU and the card, it must be given.
    Collective on the first call for a layout: every rank calls it, in the
    same order."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {data}x{model} mesh needs a process group: call "
            "parallel.init_distributed() first (apps.train --multihost "
            "under torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if model < 1 or world % model:
        raise ValueError(f"mesh model axis {model} does not divide the "
                         f"world size {world}")
    if data == -1:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, "
                         f"the process group has {world}")
    if device is None:
        if dist.get_backend() != "nccl":
            raise ValueError(
                f"a mesh over a {dist.get_backend()} process group needs its "
                "device (\"cpu\" or a card)")
        device = torch.device("cuda", torch.cuda.current_device())
    d, m = divmod(rank, model)
    data_group, model_group = _axis_groups(world, data, model)
    return Mesh(data, model, d, m, data_group, model_group, torch.device(device))


def default_render_mesh(sample_shards: int = 1, device=None
                        ) -> Optional[Mesh]:
    """The mesh eval and video render on: None in one process (or a world
    of one); else all ranks on the data axis, or, with ``sample_shards`` >
    1, ``(world // sample_shards, sample_shards)``, which
    ``render_image`` composites over. ``device`` as in :func:`make_mesh`."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return make_mesh(-1, sample_shards, device=device)


# --- placing batches ---------------------------------------------------------

def _rows(mesh: Mesh, x):
    b = x.shape[0]
    if b % mesh.data:
        raise ValueError(f"batch of {b} rays does not split over the "
                         f"{mesh.data} data ranks")
    per = b // mesh.data
    return x[mesh.data_index * per:(mesh.data_index + 1) * per]


def shard_batch(mesh: Mesh, rays: Rays, pixels=None):
    """This rank's rows of a global [B, c] batch, on the mesh's device."""
    rays = rays_to_device(rays_map(lambda x: _rows(mesh, x), rays),
                          mesh.device)
    if pixels is None:
        return rays
    return rays, torch.as_tensor(_rows(mesh, pixels), dtype=torch.float32,
                                 device=mesh.device)


# --- params -----------------------------------------------------------------

def _trunk_dims(i: int):
    """(dim of w, dim of b or None) that trunk layer ``i`` splits: even
    layers their output columns, odd layers their input rows (b whole)."""
    return (1, 0) if i % 2 == 0 else (0, None)


def _map_trunk(params, fn):
    """``params`` with trunk layer i's w and b replaced by fn(x, dim),
    dim from :func:`_trunk_dims`; the other subtrees as they are."""
    layers = [{"w": fn(layer["w"], _trunk_dims(i)[0]),
               "b": fn(layer["b"], _trunk_dims(i)[1])}
              for i, layer in enumerate(params["nerf"]["trunk"]["layers"])]
    nerf = dict(params["nerf"], trunk={"layers": layers})
    return dict(params, nerf=nerf)


def shard_params(mesh: Mesh, params):
    """This rank's shard of a full params tree (same nesting): the NeRF
    trunk split over the model axis (``param_shardings`` in the JAX
    package), everything else whole. Identity when ``model`` is 1."""
    if mesh.model == 1:
        return params

    def cut(x, dim):
        if dim is None:
            return x
        n = x.shape[dim]
        if n % mesh.model:
            raise ValueError(f"trunk width {n} does not split over "
                             f"{mesh.model} model ranks")
        k = n // mesh.model
        return x.narrow(dim, mesh.model_index * k, k).detach().clone()

    return _map_trunk(params, cut)


def gather_params(mesh: Mesh, params):
    """The full tree from each rank's :func:`shard_params` shard (no
    autograd). Collective over the model axis: every rank calls it."""
    if mesh.model == 1:
        return params
    return _map_trunk(params, lambda x, dim: x.detach() if dim is None else
                      gather_cat(x.detach(), mesh.model_group, dim))


def _tensors(state):
    """A train state's params and moments, in a fixed order."""
    from ..train.state import leaves

    return leaves(state.params) + [
        t for a in state.opt_state.values() for t in leaves(a.mu) + leaves(a.nu)]


def broadcast_state_(state) -> None:
    """Overwrite a full train state with global rank 0's, in place (two
    collectives over the world): params, moments, the step and update
    counters and the noise generator. After init and after a restore, so
    that every rank starts from the same state and step, even one that
    found no checkpoint to resume from."""
    with torch.no_grad():
        flat_broadcast_(_tensors(state), src=0)
    device = state.params["prop"]["layers"][0]["w"].device
    gen = state.generator.get_state()
    counters = torch.tensor([state.step, state.sched_count] +
                            [a.count for a in state.opt_state.values()],
                            dtype=torch.int64)
    packed = torch.cat([counters, gen.to(torch.int64)]).to(device)
    dist.broadcast(packed, src=0)
    packed = packed.cpu()
    state.step, state.sched_count, *counts = packed[:len(counters)].tolist()
    for a, c in zip(state.opt_state.values(), counts):
        a.count = c
    state.generator.set_state(packed[len(counters):].to(torch.uint8))


def _map_moments(state, fn):
    """{subtree: AdamState} with ``fn`` applied to the first and to the
    second moments, each as a params tree ({"prop": ..., "nerf": ...})."""
    mu, nu = (fn({k: getattr(a, name) for k, a in state.opt_state.items()})
              for name in ("mu", "nu"))
    return {k: dataclasses.replace(a, mu=mu[k], nu=nu[k])
            for k, a in state.opt_state.items()}


def shard_state(mesh: Mesh, state):
    """A full train state cut to this rank's shard: params (leaf tensors
    that require grad) and moments sharded alike; counters and generator
    shared. Identity when ``model`` is 1."""
    if mesh.model == 1:
        return state
    from ..models.mipnerf360 import map_params

    params = map_params(lambda p: p.detach().requires_grad_(),
                        shard_params(mesh, state.params))
    return dataclasses.replace(
        state, params=params,
        opt_state=_map_moments(state, lambda t: shard_params(mesh, t)))


def gather_state(mesh: Mesh, state):
    """The full train state from each rank's :func:`shard_state` shard, for
    a checkpoint (collective over the model axis). Identity when ``model``
    is 1."""
    if mesh.model == 1:
        return state
    return dataclasses.replace(
        state, params=gather_params(mesh, state.params),
        opt_state=_map_moments(state, lambda t: gather_params(mesh, t)))


def any_rank(flag: bool, mesh: Optional[Mesh]) -> bool:
    """Whether ``flag`` is set on any rank of the world (so that every rank
    takes the same branch); ``flag`` itself without a mesh."""
    if mesh is None:
        return flag
    t = torch.tensor([float(flag)], device=mesh.device)
    return bool(all_reduce_(t, None).item() > 0)


def rank0_value(x: float, mesh: Optional[Mesh]) -> float:
    """Global rank 0's ``x`` on every rank (so that every rank takes the
    same branch on it); ``x`` itself without a mesh."""
    if mesh is None:
        return x
    t = torch.tensor([x], dtype=torch.float64, device=mesh.device)
    dist.broadcast(t, src=0)
    return t.item()
