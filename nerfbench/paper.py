"""The published Mip-NeRF 360 network's layout, as the yardstick and the
weights of its cells see it: the layer shapes, the initial weights from the
seed and the MLP FLOPs a ray needs.

The layout (Barron et al., CVPR 2022, https://arxiv.org/abs/2111.12077;
multinerf ``configs/360.gin`` and its ``MLP`` defaults): a proposal MLP run
``proposal_rounds`` times on ``num_samples`` samples; an ``nerf_depth`` x
``hidden_nerf`` trunk whose input is concatenated to the output of hidden
layer i for i % ``trunk_skip`` == 0, 0 < i < depth - 1; a density head and
a linear ``bottleneck_width`` bottleneck on the trunk; the bottleneck and
the 3 + 6 x scales view-direction features into one ``viewdir_width`` ReLU
layer and the rgb head, on ``nerf_samples`` samples. A configuration
without these keys is the repo's own layout (one round, no skip, the heads
on the trunk, the 4 x scales view features in its input), which
``yardstick.mlp_towers`` counts alike. The composite kernels K1 and K2 run
once a round and once on the NeRF level, each at its own [rays, samples].
Everything here is worked out from
the configuration's numbers, never from the program, as in
``yardstick.py``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .weights import stream_seed
from .yardstick import k1_bound_s, k2_bound_s

# (tower, [(fan_in, fan_out, inputs that take a gradient), ...], samples a
# ray) in the order the weights are drawn.
Tower = Tuple[str, List[Tuple[int, int, int]], int]


def _get(model: dict, key: str):
    """A layout number of ``model``, the repo layout's where it is absent."""
    defaults = {"proposal_rounds": 1, "nerf_samples": 0, "trunk_skip": 0,
                "bottleneck_width": 0, "viewdir_width": 0}
    return model.get(key, defaults[key])


def skip_layers(model: dict) -> List[int]:
    """The trunk layers that take the input beside the hidden features."""
    k, depth = _get(model, "trunk_skip"), model["nerf_depth"]
    return [i + 1 for i in range(1, depth - 1) if k and i % k == 0]


def towers(model: dict) -> List[Tower]:
    """Every layer's shape and how many of its inputs take a gradient (none
    for the encoded samples; the skip layer's hidden features only; the
    view layer's bottleneck features only)."""
    hp, hn = model["hidden_proposal"], model["hidden_nerf"]
    bw, vw = _get(model, "bottleneck_width"), _get(model, "viewdir_width")
    views = model["viewdir_max_deg"] - model["viewdir_min_deg"]
    d = 42 * (model["ipe_max_deg"] - model["ipe_min_deg"]) + (0 if bw else
                                                             4 * views)
    prop = [(d, hp, 0)] + [(hp, hp, hp)] * (model["proposal_depth"] - 1) + [
        (hp, 1, hp)]
    skips = skip_layers(model)
    trunk = [(d, hn, 0)] + [((hn + d, hn, hn) if i in skips else (hn, hn, hn))
                            for i in range(1, model["nerf_depth"])]
    n_prop = _get(model, "proposal_rounds") * model["num_samples"]
    n_nerf = _get(model, "nerf_samples") or model["num_samples"]
    heads = [("density", [(hn, 1, hn)], n_nerf)]
    if bw:
        heads += [("bottleneck", [(hn, bw, hn)], n_nerf),
                  ("rgb", [(bw + 3 + 6 * views, vw, bw), (vw, 3, vw)], n_nerf)]
    else:
        heads += [("rgb", [(hn, 3, hn)], n_nerf)]
    return [("prop", prop, n_prop), ("trunk", trunk, n_nerf)] + heads


def make_params(model: dict, seed: int, device) -> dict:
    """The initial weights of the layout on ``device`` from ``seed``, drawn
    as ``weights.make_params`` draws the repo's layout's: Kaiming-uniform
    from one ``torch.rand`` of stream 1, in float32. The skip layer's rows
    are the hidden features', then the input's; the view layer's, the
    bottleneck's, then the direction encoding's."""
    gen = torch.Generator(device).manual_seed(stream_seed(seed, 1))
    shapes = [(fi, fo) for _, layers, _ in towers(model) for fi, fo, _ in layers]
    u = torch.rand(sum(fi * fo + fo for fi, fo in shapes), generator=gen,
                   device=device, dtype=torch.float32)
    out, pos = {}, 0
    for name, layers, _ in towers(model):
        out[name] = {"layers": []}
        for fi, fo, _ in layers:
            w = u[pos:pos + fi * fo].view(fi, fo)
            pos += fi * fo
            b = u[pos:pos + fo]
            pos += fo
            wb, bb = (6.0 / fi) ** 0.5, 1.0 / fi ** 0.5
            out[name]["layers"].append({"w": w * (2 * wb) - wb,
                                        "b": b * (2 * bb) - bb})
    return {"prop": out.pop("prop"), "nerf": out}


def flops_per_ray(model: dict, train: bool = True) -> int:
    """MLP GEMM FLOPs one ray needs: per layer and sample 2 x in x out
    forward, and in training the same for dW and 2 x (inputs that take a
    gradient) x out for dX; the proposal MLP on its rounds' samples, the
    NeRF MLPs on the NeRF level's."""
    total = 0
    for _, layers, samples in towers(model):
        for fi, fo, grad_in in layers:
            per = 2 * fi * fo
            if train:
                per += 2 * fi * fo + 2 * grad_in * fo
            total += samples * per
    return total


def composite_shapes(model: dict, rays: int) -> List[List[int]]:
    """The [rays, samples] of each K1 launch of a forward, in order, which
    are also those of each K2 launch of a train step: every proposal
    round's, then the NeRF level's."""
    n_nerf = _get(model, "nerf_samples") or model["num_samples"]
    return ([[rays, model["num_samples"]]] * _get(model, "proposal_rounds")
            + [[rays, n_nerf]])


def composite_bound_s(shapes: dict, k1_launches: int, k2_launches: int
                      ) -> float:
    """Least time of ``k1_launches`` K1 and ``k2_launches`` K2 launches by
    their bytes (``yardstick.k1_bound_s``, ``k2_bound_s``). ``shapes`` maps
    "K1" and "K2" to one [rays, samples] or to the list of a step's
    launches (:func:`composite_shapes`); each launch counts at their mean."""
    def mean(bound, s):
        s = [s] if isinstance(s[0], int) else s
        return sum(bound(*x) for x in s) / len(s)

    return (k1_launches * mean(k1_bound_s, shapes["K1"])
            + k2_launches * mean(k2_bound_s, shapes["K2"]))
