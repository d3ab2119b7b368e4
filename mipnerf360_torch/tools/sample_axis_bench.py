"""Render rays/s on one card against samples per ray (counterpart of the
single-chip rows of the JAX package's ``tools/sample_axis_bench.py``).

    python -m mipnerf360_torch.tools.sample_axis_bench [--samples 64 128 256 512]
    python -m mipnerf360_torch.tools.sample_axis_bench --out rows.json
    python -m mipnerf360_torch.tools.sample_axis_bench --device cpu --samples 8 16 --chunk 64

For each N in ``--samples`` the flagship ``ModelConfig(num_samples=N)``
renders ``4 * chunk`` dummy rays in chunks of ``chunk = max(256, --chunk *
64 // N)``: the chunk shrinks as N grows, keeping the per-chunk activation
footprint comparable, which is the regime ``ModelConfig.sample_shards``
exists for. Each row is one JSON line (``num_samples``, ``chunk``,
``render_rays_per_sec``, ``samples_per_sec``, ``card``), the median of
``REPEATS`` renders after ``WARMUP``, each ending in a sync on ``rgb[0,
0]``. The rows go to a file only under ``--out PATH``.

The JAX tool's ``--virtual`` rows only check that the sample-sharded render
is exact across shards on a virtual CPU mesh; here
``tests/test_torch_render_mesh.py`` checks that on gloo ranks, so this tool
has no ``--virtual``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

from ..config import ModelConfig
from ..core.rays import dummy_rays, rays_to_device, resolve_device
from ..models.mipnerf360 import init_model, render_image
from .bench import card_name, time_windows

WARMUP, REPEATS = 3, 3


def chunk_for(n: int, chunk: int) -> int:
    """The row's chunk: ``chunk`` rays at 64 samples, fewer as N grows, at
    least 256."""
    return max(256, chunk * 64 // n)


def run(args, base: ModelConfig = ModelConfig()) -> list:
    """One row per N in ``args.samples`` on ``base`` at that N; prints each
    row, writes them to ``args.out`` when given, and returns them."""
    device = resolve_device(args.device)
    card = card_name(device)
    rows = []
    for n in args.samples:
        chunk = chunk_for(n, args.chunk)
        cfg = dataclasses.replace(base, num_samples=n)
        params = init_model(cfg)
        n_rays = 4 * chunk
        rays = rays_to_device(dummy_rays(n_rays), device)

        def call():
            rgb, _, _ = render_image(params, cfg, rays, chunk=chunk,
                                     device=device)
            return float(rgb[0, 0])

        rps = statistics.median(n_rays / dt for dt in
                                time_windows(call, WARMUP, REPEATS))
        rows.append({"num_samples": n, "chunk": chunk,
                     "render_rays_per_sec": round(rps, 1),
                     "samples_per_sec": round(rps * n, 1), "card": card})
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"single_chip": {"card": card, "rows": rows}}, f,
                      indent=2)
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--samples", type=int, nargs="+",
                    default=[64, 256, 512, 1024])
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--out", default="",
                    help="also write the rows to this JSON file")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; cpu for the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
