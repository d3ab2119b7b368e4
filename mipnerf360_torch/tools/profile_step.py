"""The train step split into timed pieces (counterpart of the JAX package's
``tools/profile_step.py``: the same pieces, names and order).

    python -m mipnerf360_torch.tools.profile_step [--quality] [--steps 10]
    python -m mipnerf360_torch.tools.profile_step --device cpu --batch 64 --steps 2

Each piece is called once to warm, then ``--steps`` times between two CUDA
events, ``REPEATS`` times over; a line per piece gives the median device ms
per call and, beside it, the host clock around the same calls (ending in a
synchronize). In eager PyTorch a piece is a run of launches from Python, so
where the host time exceeds the device time the difference is launch
overhead that the card waited on. The last line is one JSON object with
every piece and the card. With ``--device cpu`` only the host clock exists
and the device time reads null.

The JAX tool perturbs each piece's inputs by ``c * 1e-12`` inside one
``lax.scan`` so that XLA cannot hoist loop-invariant work out of the loop;
eager PyTorch hoists nothing, so the inputs here are fixed. Forward pieces
run under ``torch.no_grad`` (the JAX pieces build no backward either);
"nerf trunk fwd+bwd" takes the gradient with respect to the trunk's weights
and its input, the backward the train step runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

from ..config import QUALITY_MODEL, Config, ModelConfig, TrainConfig
from ..core.rays import dummy_rays, rays_map, rays_to_device, resolve_device
from ..core.sampling import resample_along_rays
from ..losses.distillation import distillation_loss
from ..losses.distortion import distortion_loss
from ..models.mipnerf360 import (_compute_dtype, _encode, _trunk_activations,
                                 nerf_forward, prop_forward)
from ..models.mlp import apply_mlp
from ..train.state import init_train_state, leaves
from ..train.step import make_train_loop
from .bench import card_name

# Timed runs of --steps calls per piece; the median is printed.
REPEATS = 3


def time_piece(name: str, fn, k: int, device) -> dict:
    """Device and host ms per call of ``fn``: one warm call, then the
    median of REPEATS runs of ``k`` calls."""
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn()
    sync()
    dev, host = [], []
    for _ in range(REPEATS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        if cuda:
            end.record()
        sync()
        host.append((time.perf_counter() - t0) * 1e3 / k)
        if cuda:
            dev.append(start.elapsed_time(end) / k)
    row = {"name": name, "device_ms": statistics.median(dev) if cuda else None,
           "host_ms": statistics.median(host)}
    shown = ("not measured" if row["device_ms"] is None
             else f"{row['device_ms']:9.3f} ms/step")
    print(f"{name:44s} device {shown}   host {row['host_ms']:9.3f} ms/step",
          flush=True)
    return row


def pieces(mcfg: ModelConfig, batch: int, device):
    """(name, fn) of every piece, in the JAX tool's order, on inputs made
    once from fixed seeds."""
    gen = torch.Generator(device).manual_seed(1)
    cfg = Config(model=mcfg, train=TrainConfig(batch_size=batch,
                                               cadence="joint"))
    state = init_train_state(mcfg, cfg.train, device=device)
    params = state.params
    rays = rays_to_device(dummy_rays(batch), device)
    B, N = batch, mcfg.num_samples
    dt = _compute_dtype(mcfg)
    trunk = params["nerf"]["trunk"]
    acts = _trunk_activations(mcfg)

    # 1. the matmul floor: the nerf trunk's shapes on constant activations
    x = torch.ones((B * N, mcfg.padded_input_dim), dtype=dt, device=device)

    @torch.no_grad()
    def trunk_fwd():
        return apply_mlp(trunk, x, acts, dt).float().sum()

    xg = x.clone().requires_grad_()

    def trunk_fwd_bwd():
        out = apply_mlp(trunk, xg, acts, dt)
        return torch.autograd.grad(out.float().sum(), leaves(trunk) + [xg])

    # 2-3. the two levels' forwards, at fixed proposal outputs for the NeRF
    @torch.no_grad()
    def prop():
        return prop_forward(params, mcfg, rays, True, generator=gen)[1].sum()

    with torch.no_grad():
        t_prop, w_prop = prop_forward(params, mcfg, rays, True, generator=gen)

    @torch.no_grad()
    def nerf():
        return nerf_forward(params, mcfg, rays, t_prop, w_prop, True,
                            generator=gen)["rgb"].sum()

    # 4. the encode alone (cast_rays + IPE) at the nerf sample count
    tv = torch.linspace(0.1, 5.0, N + 1, device=device).expand(B, N + 1)

    @torch.no_grad()
    def encode():
        return _encode(mcfg, rays, tv).float().sum()

    # 5. resample and the two losses at the step's shapes
    u = lambda *s: torch.rand(s, generator=gen, device=device)
    w_fine, w_coarse = u(B, N), u(B, N)
    t_fine = torch.sort(u(B, N + 1) * 5 + 0.1, dim=-1).values
    t_coarse = torch.sort(u(B, N + 1) * 5 + 0.1, dim=-1).values
    sv = torch.linspace(0, 1, N + 1, device=device).expand(B, N + 1)
    wc = w_coarse.clone().requires_grad_()
    wf = w_fine.clone().requires_grad_()

    def resample():
        return resample_along_rays(t_coarse, w_coarse, True, 0.01,
                                   generator=gen).sum()

    def distill():
        return torch.autograd.grad(
            distillation_loss(t_fine, w_fine, t_coarse, wc), wc)[0].sum()

    def distort():
        return torch.autograd.grad(distortion_loss(sv, wf), wf)[0].sum()

    # 6. the full joint step through the production loop, one step per
    # call (last: it updates the params in place)
    loop = make_train_loop(cfg)
    rays1 = rays_map(lambda r: r[None], rays)
    pix1 = torch.full((1, B, 3), 0.5, device=device)

    def step():
        return loop(state, rays1, pix1)[1]["loss"]

    return [
        ("nerf trunk fwd (matmul floor)", trunk_fwd),
        ("nerf trunk fwd+bwd", trunk_fwd_bwd),
        ("prop_forward", prop),
        ("nerf_forward (resample+encode+mlp+comp)", nerf),
        ("encode (cast_rays+IPE)", encode),
        ("resample (blur+inv-CDF)", resample),
        ("distillation loss fwd+bwd", distill),
        ("distortion loss fwd+bwd", distort),
        ("FULL train step (joint)", step),
    ]


def run(args, base: ModelConfig = ModelConfig()) -> dict:
    """Time every piece of ``base`` (with ``--pallas`` and, under
    ``--quality``, QUALITY_MODEL); prints a line per piece and the JSON
    line, and returns the JSON line's dict."""
    device = resolve_device(args.device)
    kw = dict(use_pallas=args.pallas)
    if args.quality:
        kw.update(QUALITY_MODEL)
    mcfg = dataclasses.replace(base, **kw)
    card = card_name(device)
    print(f"profile_step: batch {args.batch}, {mcfg.num_samples} samples, "
          f"input {mcfg.input_dim}, {args.steps} calls x {REPEATS}; on {card}",
          flush=True)
    rows = [time_piece(name, fn, args.steps, device)
            for name, fn in pieces(mcfg, args.batch, device)]
    out = {"pieces": rows, "batch": args.batch,
           "num_samples": mcfg.num_samples, "input_dim": mcfg.input_dim,
           "card": card}
    print(json.dumps(out), flush=True)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=10,
                    help="calls per timed run of each piece")
    ap.add_argument("--pallas", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--quality", action="store_true",
                    help="profile the quality model (QUALITY_MODEL "
                         "overrides: multi-scale IPE deg 5, input width 226) "
                         "instead of the single-scale parity model")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; cpu for the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
