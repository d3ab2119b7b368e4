"""Worker of tests/test_torch_parallel.py's sample-axis tests (not a pytest
module); 4 ranks, usage in ``_torch_ranks.py``.

On a (1, 4) and a (2, 2) mesh it runs the sample-sharded composite on the
batch of ``sample_axis_batch`` (each rank its data rows and its run of
samples), with and without a white background, and the gradient of
sum(rgb^2) + sum(acc) with respect to its density; checks that an
indivisible sample axis raises; and renders with ``sample_shards`` 4 and 2
beside the one-rank render (then each three times more, counting the
process groups), and that 3 shards do not divide the world.
"""
import dataclasses
import sys

import numpy as np
import torch
from torch.distributed import distributed_c10d as c10d

from _torch_ranks import join, save

RANK, NPROC, OUT, _ = join(sys.argv)

from mipnerf360_torch.config import ModelConfig  # noqa: E402
from mipnerf360_torch.core.rays import dummy_rays  # noqa: E402
from mipnerf360_torch.models import mipnerf360 as tm  # noqa: E402
from mipnerf360_torch.parallel import make_mesh  # noqa: E402
from mipnerf360_torch.parallel.sample_axis import (  # noqa: E402
    make_sample_sharded_composite)


def sample_axis_batch():
    """The batch of the JAX package's tests/test_parallel.py."""
    rng = np.random.default_rng(0)
    b, n = 16, 64
    t = np.sort(rng.uniform(0.1, 6.0, (b, n + 1)), axis=-1).astype(np.float32)
    density = rng.gamma(1.0, 2.0, (b, n)).astype(np.float32)
    rgb = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    return rgb, density, t, dirs


out = {}
rgb, density, t_vals, dirs = map(torch.from_numpy, sample_axis_batch())
for data, model in ((1, 4), (2, 2)):
    mesh = make_mesh(data, model, device="cpu")
    per = rgb.shape[0] // data
    rows = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    for white in (False, True):
        fn = make_sample_sharded_composite(mesh, white)
        sl = fn.local_slice(density.shape[-1])
        d = density[rows, sl].clone().requires_grad_()
        c_rgb, dist, acc, w = fn(rgb[rows, sl], d, t_vals[rows], dirs[rows])
        (g,) = torch.autograd.grad(torch.sum(c_rgb**2) + torch.sum(acc), [d])
        tag = f"{model}_{int(white)}"
        out.update({f"rgb_{tag}": c_rgb, f"distance_{tag}": dist,
                    f"acc_{tag}": acc, f"weights_{tag}": w,
                    f"grad_{tag}": g})
    out[f"rows_{model}"] = np.arange(per) + mesh.data_index * per
    out[f"samples_{model}"] = np.arange(sl.start, sl.stop)
    try:
        fn(rgb[rows, :63], density[rows, :63], t_vals[rows, :64], dirs[rows])
    except ValueError:
        out[f"indivisible_raised_{model}"] = 1
    else:
        out[f"indivisible_raised_{model}"] = 0

cfg = ModelConfig(num_samples=16, hidden_proposal=16, hidden_nerf=32,
                  nerf_depth=2, compute_dtype="float32")
params = tm.init_model(cfg, torch.Generator().manual_seed(0))
rays = dummy_rays(64)


def render(shards):
    got = tm.render_image(params, dataclasses.replace(cfg, sample_shards=shards),
                          rays, chunk=32, device="cpu")
    return torch.cat([x.reshape(64, -1) for x in got], -1)


for shards in (1, 4, 2):
    out[f"render_{shards}"] = render(shards)
out["groups_after_first"] = len(c10d._world.pg_map)
for _ in range(3):
    for shards in (4, 2):
        out[f"render_{shards}_again"] = render(shards)
out["groups_after_repeats"] = len(c10d._world.pg_map)
try:
    render(3)
except ValueError:
    out["three_shards_raised"] = 1
else:
    out["three_shards_raised"] = 0
save(OUT, RANK, **out)
