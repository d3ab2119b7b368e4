"""Benchmark: training rays/s per card (counterpart of the root ``bench.py``).

    python -m mipnerf360_torch.tools.bench [--batch 4096 --steps 20 ...]
    python -m mipnerf360_torch.tools.bench --mode render --quality
    python -m mipnerf360_torch.tools.bench --device cpu --batch 64 --steps 2
    torchrun --standalone --nproc_per_node=N -m mipnerf360_torch.tools.bench

Default (no mode flag): ONE JSON line whose ``value`` is the end-to-end
rate a user of the quality presets gets, the quality model
(``config.QUALITY_MODEL``, input width 226) with per-chunk batch staging
inside the timed window, as the trainer stages (``train/trainer.py``:
``upload_bank``, ``stage_chunk``, ``BackgroundStager``), and a ``detail``
with the {parity compute, quality compute, quality staging} triple and the
MFU of the matmuls against ``PEAK_TFLOPS_BF16``. ``--quality`` /
``--staging`` / ``--parity-only`` select one measurement instead.

    {"metric": "train_rays_per_sec_per_chip", "value": N, "unit": "rays/s",
     "vs_baseline": R, "card": "...", "detail": {...}}

``vs_baseline`` divides by the reference's training rays/s in
``BASELINE_MEASURED.json`` (the PyTorch reference, measured on a CPU; see
that file). ``card`` is the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them ("cpu" with
``--device cpu``).

Timing: the train loops (``train/step.py::make_train_loop`` and
``make_banked_train_loop``) queue K steps from Python without a host sync.
Each window starts on the host clock before the first dispatch and ends
after ``float(aux["loss"][-1])``; ``--repeats`` windows follow at least two
warm-up calls, ``value`` is their median, and ``detail["spread"]`` holds the
min, the max and the count. Compute-only windows reuse one batch that was
put on the device once; staging windows each take the stager's next chunk.
The bench sets no backend flag that ``apps.train`` does not set.

Under torchrun (``WORLD_SIZE`` > 1) each rank joins the process group
(``parallel/mesh.py::init_distributed``) and takes its rows of the global
batch on the data mesh over all ranks; ``value`` is global rays / s / rank,
and only rank 0 prints.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import time
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import QUALITY_MODEL, Config, MeshConfig
from ..core.rays import dummy_rays, rays_map, rays_to_device, resolve_device
from ..data import get_dataset
from ..models.mipnerf360 import init_model, render_image
from ..parallel.mesh import (broadcast_state_, init_distributed, is_primary,
                             make_mesh, rank_device, shard_batch, shard_state,
                             shutdown)
from ..train.state import TrainState, init_train_state
from ..train.step import make_banked_train_loop, make_train_loop
from ..train.trainer import (BackgroundStager, stage_chunk, stage_depth,
                             upload_bank)

# H100 SXM peak dense bf16 matmul rate (NVIDIA data sheet, at 700 W).
PEAK_TFLOPS_BF16 = 989.0
BASELINE_PATH = Path(__file__).resolve().parents[2] / "BASELINE_MEASURED.json"


def matmul_flops_per_ray(mcfg) -> float:
    """Analytic matmul FLOPs for ONE ray's forward pass (prop + nerf towers,
    num_samples points each; 2 FLOPs per MAC). Backward adds 2x (dgrad +
    wgrad), so a joint-cadence train step is ~3x this. Encode/resample/
    composite (VPU work) are excluded — this is MFU *of the matmuls*.

    It counts the repo's layout only: a config with more than one proposal
    round, another NeRF sample count, a trunk skip or a view branch (the
    published network, ``garden_paper``) raises ValueError; the benchmark's
    ``nerfbench/paper.py`` counts that one."""
    if (mcfg.proposal_rounds != 1 or mcfg.nerf_sample_count != mcfg.num_samples
            or mcfg.trunk_skip or mcfg.bottleneck_width):
        raise ValueError(
            "matmul_flops_per_ray counts the repo's layout (one proposal "
            "round, no skip, no view branch), not the published network's")
    d_in = mcfg.input_dim
    hp, hn = mcfg.hidden_proposal, mcfg.hidden_nerf
    prop = d_in * hp + (mcfg.proposal_depth - 1) * hp * hp + hp * 1
    nerf = d_in * hn + (mcfg.nerf_depth - 1) * hn * hn + hn * 1 + hn * 3
    return 2.0 * mcfg.num_samples * (prop + nerf)


def card_name(device) -> str:
    """The name and power limit of the card ``device`` is on, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them; "cpu" for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    index = torch.cuda.current_device() if device.index is None else device.index
    return lines[min(index, len(lines) - 1)].strip()


def spread(rates: List[float]) -> dict:
    return {"min": round(min(rates), 1), "max": round(max(rates), 1),
            "windows": len(rates)}


def time_windows(call, warmup: int, repeats: int) -> List[float]:
    """Seconds of each of ``repeats`` calls of ``call`` (which ends in a
    host sync), after ``max(2, warmup)`` untimed ones."""
    for _ in range(max(2, warmup)):
        call()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    return times


class Measurement(NamedTuple):
    rays_per_sec: List[float]     # per window, per rank
    cfg: Config
    state: TrainState
    losses: List[torch.Tensor]    # the [K] losses of each call, on the CPU


def bench_config(args, base: Config, quality: bool, world: int = 1) -> Config:
    """``base`` with the bench's flags: the quality model or the parity one,
    ``--batch`` rays per step, the joint cadence, ``world`` data ranks."""
    model_kw = dict(remat=args.remat, use_pallas=args.pallas,
                    pad_input_lanes=args.pad_lanes)
    if quality:
        model_kw.update(QUALITY_MODEL)
    return dataclasses.replace(
        base, model=dataclasses.replace(base.model, **model_kw),
        train=dataclasses.replace(base.train, batch_size=args.batch,
                                  cadence="joint"),
        mesh=MeshConfig(data=world, model=1))


def fixed_batch(batch: int, k: int, device, mesh=None):
    """The compute-only loop args: ``dummy_rays(batch)`` and pixels from
    ``default_rng(0)`` (this rank's rows of them on ``mesh``), put on the
    device once and expanded to [k, ...] without a copy."""
    rays_np = dummy_rays(batch)
    pixels_np = np.random.default_rng(0).uniform(
        0, 1, (batch, 3)).astype(np.float32)
    if mesh is None:
        rays = rays_to_device(rays_np, device)
        pixels = torch.as_tensor(pixels_np, device=device)
    else:
        rays, pixels = shard_batch(mesh, rays_np, pixels_np)
    stack = lambda x: x.expand((k,) + x.shape)
    return rays_map(stack, rays), stack(pixels)


def measure(args, cfg: Config, staging: bool, device,
            mesh=None) -> Measurement:
    """Training rays/s per rank of one (model, data path) combination:
    ``args.steps`` steps per call through the production loops, from the
    trainer's initial state.

    Compute-only: one :func:`fixed_batch` for every call. Staging: the
    trainer's staging functions over the default synthetic train split,
    the bank unless ``args.stage_host``; a ``BackgroundStager`` of the
    trainer's depth gets ``repeats + depth`` chunks and is warmed before
    the first window, so the worker assembles one chunk per timed round."""
    K, B = args.steps, args.batch
    world = 1 if mesh is None else mesh.data
    state = init_train_state(cfg.model, cfg.train, device=device)
    if mesh is not None:
        broadcast_state_(state)
        state = shard_state(mesh, state)
    if staging:
        dataset = get_dataset(cfg.data, "train",
                              white_bkgd=cfg.model.white_bkgd)
        bank = None if args.stage_host else upload_bank(dataset, device)
        loop_fn = (make_train_loop(cfg, mesh=mesh) if bank is None
                   else make_banked_train_loop(cfg, mesh=mesh))

        def make_batch(step0: int):
            return stage_chunk(dataset, bank, device, K, B, cfg.train.seed,
                               step0, mesh)
    else:
        loop_fn = make_train_loop(cfg, mesh=mesh)
        batch = fixed_batch(B, K, device, mesh)

        def make_batch(step0: int):
            return batch

    losses = []

    def call(loop_args):
        nonlocal state
        state, aux = loop_fn(state, *loop_args)
        float(aux["loss"][-1])
        return aux["loss"]

    for i in range(max(2, args.warmup)):
        losses.append(call(make_batch(i * K)).cpu())
    times, stager = [], None
    if staging:
        depth = stage_depth(bank)
        stager = BackgroundStager(
            make_batch, [(1000 + i) * K for i in range(args.repeats + depth)],
            depth=depth)
    next_args = stager.get if stager else (lambda: batch)
    try:
        if stager:
            stager.warm()
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            loss = call(next_args())
            times.append(time.perf_counter() - t0)
            losses.append(loss.cpu())
        if stager:
            stager.warm()    # the last `depth` chunks, outside the windows
    finally:
        if stager:
            stager.close()
    if not np.isfinite(float(losses[-1][-1])):
        raise RuntimeError(f"final loss {float(losses[-1][-1])} is not finite")
    return Measurement([K * B / dt / world for dt in times], cfg, state,
                       losses)


def vs_ref(rays_per_sec_per_chip: float) -> Optional[float]:
    if BASELINE_PATH.exists():
        ref_rays = json.loads(BASELINE_PATH.read_text()).get(
            "reference_train_rays_per_sec")
        if ref_rays:
            return round(rays_per_sec_per_chip / ref_rays, 2)
    return None


def _mfu(cfg: Config, rps: float):
    """(matmul TFLOP/s per card, its share of PEAK_TFLOPS_BF16): 3x the
    forward matmul FLOPs per train step (fwd + dgrad + wgrad)."""
    tflops = 3.0 * matmul_flops_per_ray(cfg.model) * rps / 1e12
    return tflops, tflops / PEAK_TFLOPS_BF16


def bench_train(args, base: Config, device, mesh, card: str) -> dict:
    world = 1 if mesh is None else mesh.data

    def one(quality: bool, staging: bool):
        m = measure(args, bench_config(args, base, quality, world), staging,
                    device, mesh)
        return statistics.median(m.rays_per_sec), m

    single = args.quality or args.staging or args.parity_only
    if single:
        rps, m = one(args.quality, args.staging)
        name = (("quality" if args.quality else "parity")
                + ("_staging" if args.staging else "_compute"))
        out = {"metric": "train_rays_per_sec_per_chip",
               "value": round(rps, 1), "unit": "rays/s",
               "vs_baseline": vs_ref(rps), "card": card}
        if args.quality or args.staging or args.mfu:
            tflops, mfu = _mfu(m.cfg, rps)
            out.update({
                "config": ("quality (input %d)" if args.quality
                           else "parity (input %d)") % m.cfg.model.input_dim,
                "staging": bool(args.staging),
                "matmul_tflops_per_chip": round(tflops, 1),
                "mfu_matmul": round(mfu, 3),
            })
        out["detail"] = {"spread": {name: spread(m.rays_per_sec)}}
        return out

    # Headline = quality + staging: what a user training the quality
    # presets end to end gets (the trainer's perf/rays_per_sec).
    parity_rps, parity = one(quality=False, staging=False)
    quality_rps, quality = one(quality=True, staging=False)
    e2e_rps, e2e = one(quality=True, staging=True)
    _, mfu = _mfu(e2e.cfg, e2e_rps)
    return {
        "metric": "train_rays_per_sec_per_chip",
        "value": round(e2e_rps, 1),
        "unit": "rays/s",
        "vs_baseline": vs_ref(e2e_rps),
        "card": card,
        "detail": {
            "headline": "quality model, end-to-end staging",
            "parity_compute": round(parity_rps, 1),
            "quality_compute": round(quality_rps, 1),
            "quality_staging": round(e2e_rps, 1),
            "mfu_matmul_headline": round(mfu, 3),
            "spread": {"parity_compute": spread(parity.rays_per_sec),
                       "quality_compute": spread(quality.rays_per_sec),
                       "quality_staging": spread(e2e.rays_per_sec)},
        },
    }


def bench_render(args, base: Config, device, mesh, card: str) -> dict:
    """Deterministic render throughput (``render_image``) over ``batch *
    steps`` dummy rays in chunks of ``batch``; each window ends in a sync
    on ``rgb[0, 0]``."""
    cfg = bench_config(args, base, args.quality)
    params = init_model(cfg.model)
    n_rays = args.batch * args.steps
    rays = rays_to_device(dummy_rays(n_rays), device)
    world = 1 if mesh is None else mesh.data

    def call():
        rgb, _, _ = render_image(params, cfg.model, rays, chunk=args.batch,
                                 mesh=mesh, device=device)
        return float(rgb[0, 0])

    rates = [n_rays / dt / world
             for dt in time_windows(call, args.warmup, args.repeats)]
    out = {"metric": "render_rays_per_sec_per_chip",
           "value": round(statistics.median(rates), 1), "unit": "rays/s",
           "vs_baseline": None, "card": card}
    if args.quality:
        out["config"] = "quality (input %d)" % cfg.model.input_dim
    out["detail"] = {"spread": {"render": spread(rates)}}
    return out


@contextlib.contextmanager
def placement(device):
    """(device, mesh) of the bench. Under torchrun with ``WORLD_SIZE`` > 1
    the process joins the group (and leaves it on exit); in a group of more
    than one rank, the data mesh over all ranks; else ``device`` and no
    mesh."""
    joined = (int(os.environ.get("WORLD_SIZE", "1")) > 1
              and not dist.is_initialized())
    if joined:
        device = init_distributed(device)
    try:
        if dist.is_initialized() and dist.get_world_size() > 1:
            device = rank_device(device)
            yield device, make_mesh(dist.get_world_size(), 1, device=device)
        else:
            yield resolve_device(device), None
    finally:
        if joined:
            shutdown()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed windows after the warm-up; value is their "
                         "median")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--pallas", default="auto", choices=["auto", "on", "off"],
                    help="ModelConfig.use_pallas; 'off' raises on the card, "
                         "which has no plain composite path")
    ap.add_argument("--quality", action="store_true",
                    help="bench the converging quality model "
                         "(config.py QUALITY_MODEL: linear density head, "
                         "multi-scale IPE deg 5 -> input width 226) instead "
                         "of the single-scale parity model")
    ap.add_argument("--pad-lanes", action="store_true",
                    help="zero-pad the encoded input to a 128-lane multiple "
                         "(ModelConfig.pad_input_lanes); MFU is still "
                         "computed from the unpadded (useful) FLOPs")
    ap.add_argument("--staging", action="store_true",
                    help="include per-chunk batch staging in the timed "
                         "window, through the trainer's staging functions "
                         "and stager: the device bank + index uploads")
    ap.add_argument("--stage-host", action="store_true",
                    help="with --staging: host gathers + whole-batch "
                         "uploads (train.stage_mode=host) instead of the "
                         "device bank")
    ap.add_argument("--mfu", action="store_true",
                    help="add mfu_matmul/config keys to the output")
    ap.add_argument("--mode", default="train", choices=["train", "render"],
                    help="render: deterministic render_image throughput "
                         "(the eval/video serving path) instead of training")
    ap.add_argument("--parity-only", action="store_true",
                    help="single measurement of the parity model, compute "
                         "only, instead of the triple")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; cpu for the CPU)")
    return ap.parse_args(argv)


def run(args, base: Optional[Config] = None) -> dict:
    """Run the bench of ``args`` on ``base`` (the default ``Config()``:
    full width, the synthetic scene) and print its JSON line on rank 0;
    returns the line's dict."""
    base = base or Config()
    with placement(args.device) as (device, mesh):
        card = card_name(device)
        fn = bench_render if args.mode == "render" else bench_train
        out = fn(args, base, device, mesh, card)
        if is_primary():
            print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
