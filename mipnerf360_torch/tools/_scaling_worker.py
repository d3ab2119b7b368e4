"""One rank of the scaling harness (counterpart of the JAX package's
``tools/_scaling_worker.py``); ``tools/scaling.py`` starts one process per
rank.

    python -m mipnerf360_torch.tools._scaling_worker --rank R --world W \
        --init-method file:///tmp/rdv [--device cuda|cpu] [--backend nccl|gloo] \
        [--batch 2048] [--steps 20] [--reps 5] [--threads N]

Each rank joins the process group (``parallel/mesh.py::init_distributed``:
gloo on the CPU; on the card NCCL with one card per rank, or gloo with
``--backend gloo`` when ranks share a card, which NCCL refuses), builds the
JAX worker's model (32 samples per ray, a 64-wide proposal MLP, a 256x4 NeRF
MLP, float32 matmuls, the joint cadence) on the data mesh over all ranks,
takes its rows of one fixed global batch (``dummy_rays(batch)`` for every
step and pixels from ``default_rng(0)``, ``--steps`` deep) and runs the
production loop (``train/step.py::make_train_loop``): two warm-up calls,
then ``--reps`` timed calls. Each window starts after a barrier and ends
on ``float(aux["loss"][-1])``, the bench's end of window. Rank 0 prints one
JSON line:

    {"global_devices": W, "steps_per_sec": S, "steps_per_sec_std": s,
     "steps_per_sec_reps": [...], "rays_per_sec": R, "card": "...",
     "losses": [the K losses of the last call],
     "first_losses": [the K losses of the first call], "backend": "...",
     "threads": T, "launches": {"composite_fwd": n, "composite_bwd": m}}

``launches`` counts rank 0's K1 and K2 launches over every call (0 on the
CPU, where the composite takes its plain version). The state advances in
place from call to call, so ranks that start alike end alike, whatever
their number.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config, DataConfig, MeshConfig, ModelConfig, TrainConfig
from ..core.rays import dummy_rays, rays_map, rays_to_device
from ..ops import composite
from ..parallel.mesh import (broadcast_state_, init_distributed, make_mesh,
                             shutdown)
from ..train.state import init_train_state
from ..train.step import make_train_loop
from .bench import card_name

# The JAX worker's model (tools/_scaling_worker.py).
WORKER_MODEL = dict(num_samples=32, hidden_proposal=64, hidden_nerf=256,
                    nerf_depth=4, compute_dtype="float32")
WARMUP_CALLS = 2


def worker_config(batch: int, world: int, model: Optional[dict] = None
                  ) -> Config:
    """The worker's configuration: ``model`` (default the JAX worker's),
    ``batch`` rays per global step, the joint cadence, ``world`` ranks on
    the data axis."""
    return Config(model=ModelConfig(**(WORKER_MODEL if model is None
                                       else model)),
                  train=TrainConfig(batch_size=batch, cadence="joint"),
                  data=DataConfig(), mesh=MeshConfig(data=world, model=1))


def global_batch(batch: int, steps: int):
    """The JAX worker's batch: ``dummy_rays(batch)`` repeated for each of
    the ``steps`` steps, and [steps, batch, 3] pixels from
    ``default_rng(0)`` (NumPy, on the host)."""
    rays = rays_map(lambda x: np.broadcast_to(x[None], (steps,) + x.shape
                                              ).copy(), dummy_rays(batch))
    pixels = np.random.default_rng(0).uniform(
        0, 1, (steps, batch, 3)).astype(np.float32)
    return rays, pixels


def rank_rows(mesh, rays, pixels, device):
    """This rank's rows (axis 1) of a [K, B, ...] batch, on ``device``; the
    whole batch without a mesh."""
    if mesh is not None:
        b = pixels.shape[1]
        if b % mesh.data:
            raise ValueError(f"batch of {b} rays does not split over the "
                             f"{mesh.data} data ranks")
        per = b // mesh.data
        rows = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
        rays = rays_map(lambda x: x[:, rows], rays)
        pixels = pixels[:, rows]
    return (rays_to_device(rays, device),
            torch.as_tensor(pixels, dtype=torch.float32, device=device))


def run_worker(cfg: Config, state, rays, pixels, mesh=None, reps: int = 5,
               noise=None) -> dict:
    """The worker's body: ``WARMUP_CALLS`` calls of the train loop over
    this rank's ``rays`` and ``pixels`` ([K, ...], on the device), then
    ``reps`` timed ones, each after a barrier on ``mesh`` (None: one
    process, no barrier). ``noise``, when given, holds each step's
    :class:`RenderNoise` (this rank's rows) for every call. Returns the
    per-rep steps/s, the aux of the first call (each a [K] tensor on the
    CPU), the K losses of the last call, and this process's K1/K2
    launches over all calls."""
    loop = make_train_loop(cfg, mesh=mesh)
    k = pixels.shape[0]
    before = composite.launches, composite.bwd_launches
    first = last = None
    rates = []
    for i in range(WARMUP_CALLS + max(1, reps)):
        if mesh is not None:
            mesh.barrier()
        t0 = time.perf_counter()
        state, aux = loop(state, rays, pixels, noise)
        float(aux["loss"][-1])
        dt = time.perf_counter() - t0
        if i >= WARMUP_CALLS:
            rates.append(k / dt)
        if first is None:
            first = {name: v.detach().cpu() for name, v in aux.items()}
        last = aux["loss"].detach().cpu()
    return {"steps_per_sec_reps": rates, "first_aux": first,
            "losses": [float(x) for x in last], "state": state,
            "launches": {"composite_fwd": composite.launches - before[0],
                         "composite_bwd": composite.bwd_launches - before[1]}}


def worker_line(cfg: Config, result: dict, world: int, card: str,
                backend: str, threads: int) -> dict:
    """The JSON line of rank 0: the JAX worker's keys, then the card, the
    last and the first call's losses, the backend, the threads and the
    launches."""
    rates = result["steps_per_sec_reps"]
    mean = float(np.mean(rates))
    return {
        "global_devices": world,
        "steps_per_sec": round(mean, 3),
        "steps_per_sec_std": round(float(np.std(rates)), 3),
        "steps_per_sec_reps": [round(x, 3) for x in rates],
        "rays_per_sec": round(mean * cfg.train.batch_size, 1),
        "card": card,
        "losses": result["losses"],
        "first_losses": [float(x) for x in result["first_aux"]["loss"]],
        "backend": backend,
        "threads": threads,
        "launches": result["launches"],
    }


def worker_device(device: str, backend: str, rank: int, world: int
                  ) -> torch.device:
    """The device of ``rank``: the CPU; over NCCL card ``rank`` (one card
    per rank: more ranks than cards raise); over gloo card ``rank`` modulo
    the card count (ranks share cards)."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device cpu to run "
                           "the worker on the CPU")
    cards = torch.cuda.device_count()
    if backend == "nccl" and world > cards:
        raise RuntimeError(f"{world} NCCL ranks need {world} cards, this "
                           f"host has {cards} (gloo ranks can share a card: "
                           "--backend gloo)")
    return torch.device("cuda", rank % cards)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--init-method", required=True,
                    help="rendezvous of the process group (file:// or tcp://)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed calls after the warm-up; the per-rep steps/s "
                         "are reported so the caller can compute mean and std")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch.set_num_threads (0: leave the default)")
    return ap.parse_args(argv)


def main(argv=None) -> Optional[dict]:
    args = parse_args(argv)
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    if args.device == "cpu" and backend == "nccl":
        raise SystemExit("NCCL needs the card: --device cpu takes gloo")
    if args.threads > 0:
        torch.set_num_threads(args.threads)
    device = worker_device(args.device, backend, args.rank, args.world)
    init_distributed(device, backend=backend, init_method=args.init_method,
                     rank=args.rank, world_size=args.world)
    try:
        cfg = worker_config(args.batch, args.world)
        mesh = make_mesh(args.world, 1, device=device)
        state = init_train_state(cfg.model, cfg.train, device=device)
        broadcast_state_(state)
        rays, pixels = rank_rows(mesh, *global_batch(args.batch, args.steps),
                                 device)
        result = run_worker(cfg, state, rays, pixels, mesh, args.reps)
        line = None
        if args.rank == 0:
            line = worker_line(cfg, result, args.world, card_name(device),
                               backend, torch.get_num_threads())
            print(json.dumps(line), flush=True)
        mesh.barrier()
        return line
    finally:
        shutdown()


if __name__ == "__main__":
    main()
