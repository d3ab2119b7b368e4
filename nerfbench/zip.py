"""Zip-NeRF's layout, as the yardstick and the weights of its cells see it:
the grids' levels and tables, the layer shapes, the initial weights from
the seed, the MLP FLOPs a ray needs and the grid kernels' least bytes.

The layout (Barron et al., ICCV 2023, https://arxiv.org/abs/2304.06706;
camp_zipnerf ``configs/zipnerf/360.gin``): ``proposal_rounds`` proposal
rounds of ``num_samples`` samples and the NeRF level's ``nerf_samples``,
each sampling level with its own hash grid (``grid_levels`` levels from
``grid_min_res`` to its entry of ``grid_max_res``, ``grid_features``
features an entry, tables of 2^``grid_log2_table`` entries, dense where a
level's (n + 1)^3 corners fit) and its own MLP: the grid features ->
``hidden_proposal`` (ReLU) -> the raw density for a proposal; the grid
features -> ``hidden_nerf`` (ReLU) -> a linear ``bottleneck_width``
bottleneck for the NeRF level, then the bottleneck and the 3 + 6 x scales
view-direction features -> ``viewdir_depth`` ReLU layers of
``viewdir_width`` -> rgb. Each sample is ``POINTS`` points, each looked up
at 8 corners a level. Everything here is worked out from the
configuration's numbers, never from the program, as in ``yardstick.py``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .weights import stream_seed
from .yardstick import HBM_BYTES_PER_S

POINTS = 6
# The tables' scale in the benchmark's weights, U(-TABLE_SCALE,
# TABLE_SCALE): where the density varies over the scene, not the init's
# 1e-4, where every comparison would be of near-zeros.
TABLE_SCALE = 2.0
# The grid kernels, by the names the profiler gives them.
H1, H2 = "hashgrid_fwd", "hashgrid_bwd"
# Bytes of the rays' per-ray inputs a sampling level reads: origins,
# directions (3 floats each) and the radius.
RAY_BYTES = 4 * 7


def intervals(model: dict) -> List[int]:
    """Samples of each sampling level, in order."""
    return [model["num_samples"]] * model["proposal_rounds"] + [
        model["nerf_samples"]]


def grid(model: dict, level: int) -> Tuple[List[int], int]:
    """(table size of each grid level, features an entry) of sampling level
    ``level``."""
    max_res = int(str(model["grid_max_res"]).split(",")[level])
    feats = int(str(model["grid_features"]).split(",")[level])
    res = np.round(np.geomspace(model["grid_min_res"], max_res,
                                model["grid_levels"])).astype(np.int64)
    table = 2 ** model["grid_log2_table"]
    return [int(min((n + 1) ** 3, table)) for n in res.tolist()], feats


def entries(model: dict, level: int) -> int:
    return sum(grid(model, level)[0])


def towers(model: dict) -> List[Tuple[str, List[Tuple[int, int, int]], int]]:
    """(tower, [(fan_in, fan_out, inputs that take a gradient)], samples a
    ray) of every MLP in the order the weights are drawn: each proposal
    round's, the NeRF trunk, bottleneck and view branch. The grid features
    take a gradient (H2 scatters it into the tables), the direction
    features none."""
    levels = model["grid_levels"]
    out = []
    for r in range(model["proposal_rounds"]):
        d = levels * grid(model, r)[1]
        hp = model["hidden_proposal"]
        out.append((f"prop.{r}", [(d, hp, d), (hp, 1, hp)],
                    model["num_samples"]))
    n, hn = model["nerf_samples"], model["hidden_nerf"]
    d = levels * grid(model, model["proposal_rounds"])[1]
    bw, vw = model["bottleneck_width"], model["viewdir_width"]
    views = 3 + 6 * (model["viewdir_max_deg"] - model["viewdir_min_deg"])
    rgb = [(bw + views, vw, bw)] + [(vw, vw, vw)] * (
        model["viewdir_depth"] - 1) + [(vw, 3, vw)]
    out += [("trunk", [(d, hn, d)], n), ("bottleneck", [(hn, bw, hn)], n),
            ("rgb", rgb, n)]
    return out


def make_params(model: dict, seed: int, device) -> dict:
    """The initial weights on ``device`` from ``seed``: the MLPs
    Kaiming-uniform from one ``torch.rand`` of stream 1 (as
    ``weights.make_params``), the tables U(-TABLE_SCALE, TABLE_SCALE) from
    one of stream 3, each sampling level's in order, float32."""
    gen = torch.Generator(device).manual_seed(stream_seed(seed, 1))
    shapes = [(fi, fo) for _, layers, _ in towers(model)
              for fi, fo, _ in layers]
    u = torch.rand(sum(fi * fo + fo for fi, fo in shapes), generator=gen,
                   device=device, dtype=torch.float32)
    mlps, pos = {}, 0
    for name, layers, _ in towers(model):
        mlps[name] = {"layers": []}
        for fi, fo, _ in layers:
            w = u[pos:pos + fi * fo].view(fi, fo)
            pos += fi * fo
            b = u[pos:pos + fo]
            pos += fo
            wb, bb = (6.0 / fi) ** 0.5, 1.0 / fi ** 0.5
            mlps[name]["layers"].append({"w": w * (2 * wb) - wb,
                                         "b": b * (2 * bb) - bb})
    gen = torch.Generator(device).manual_seed(stream_seed(seed, 3))
    tables = []
    for level in range(model["proposal_rounds"] + 1):
        feats = grid(model, level)[1]
        t = torch.rand((entries(model, level), feats), generator=gen,
                       device=device, dtype=torch.float32)
        tables.append(t * (2 * TABLE_SCALE) - TABLE_SCALE)
    prop = [dict(mlps[f"prop.{r}"], grid=tables[r])
            for r in range(model["proposal_rounds"])]
    nerf = {k: mlps[k] for k in ("trunk", "bottleneck", "rgb")}
    nerf["grid"] = tables[-1]
    return {"prop": prop, "nerf": nerf}


def flops_per_ray(model: dict, train: bool = True) -> int:
    """MLP GEMM FLOPs one ray needs, counted as ``paper.flops_per_ray``:
    per layer and sample 2 x in x out forward, and in training the same for
    dW and 2 x (inputs that take a gradient) x out for dX; each MLP on its
    sampling level's samples."""
    total = 0
    for _, layers, samples in towers(model):
        for fi, fo, grad_in in layers:
            per = 2 * fi * fo
            if train:
                per += 2 * fi * fo + 2 * grad_in * fo
            total += samples * per
    return total


def grid_work(model: dict, rays: int) -> List[Dict[str, object]]:
    """Each sampling level's grid work a step of ``rays`` rays: its
    samples, points, levels, features and table entries per level."""
    out = []
    for level, n in enumerate(intervals(model)):
        sizes, feats = grid(model, level)
        out.append({"samples": n, "points": rays * n * POINTS,
                    "levels": len(sizes), "features": feats,
                    "entries": sizes})
    return out


def grid_bytes(model: dict, rays: int) -> int:
    """The bytes H1 and H2 cannot avoid in a train step of ``rays`` rays:
    for each sampling level, its interval ends, rays and pattern uniforms
    read once, its features written once and their cotangent read once in
    the compute dtype, and its table's gradient written once (in float32;
    the zeroing before H2 is left out, as its time is)."""
    item = 2 if model["compute_dtype"] == "bfloat16" else 4
    total = 0
    for level, n in enumerate(intervals(model)):
        sizes, feats = grid(model, level)
        width = len(sizes) * feats
        total += rays * (4 * (n + 1) + RAY_BYTES + 4 * 2 * n)
        total += 2 * rays * n * width * item
        total += 4 * sum(sizes) * feats
    return total


def grid_bound_s(model: dict, rays: int) -> float:
    """Least time of a train step's H1 and H2 launches: their bytes at the
    HBM peak."""
    return grid_bytes(model, rays) / HBM_BYTES_PER_S


def grid_seconds(kernels) -> float:
    """Device seconds of H1 and H2 in a kernel table of (name, launches,
    seconds)."""
    return sum(s for name, _, s in kernels if H1 in name or H2 in name)
