"""The weights and the noise stream of a run, made by the benchmark from
``--seed`` and handed alike to the program and to the reference.

The weights are the model's Kaiming-uniform init (weights U(+-sqrt(6 /
fan_in)), biases U(+-1 / sqrt(fan_in))), drawn on the device in one call
from a ``torch.Generator`` there, in float32, as the program trains and
serves them. The tree is the layout the program takes (``{"prop":
{"layers": [{"w": [in, out], "b": [out]}, ...]}, "nerf": {"trunk" |
"density" | "rgb": ...}}``).
"""
from __future__ import annotations

import torch

from .yardstick import mlp_towers

_GOLDEN = 0x9E3779B97F4A7C15


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of stream ``stream`` of run seed ``seed`` (any whole
    number)."""
    return ((seed * _GOLDEN) ^ (stream * 0xBF58476D1CE4E5B9)) % (2**63 - 1)


def make_params(model: dict, seed: int, device) -> dict:
    """The initial weights of ``model`` (a configuration's numbers) on
    ``device``, from ``seed``."""
    gen = torch.Generator(device).manual_seed(stream_seed(seed, 1))
    towers = mlp_towers(model)
    shapes = [(sizes[i], sizes[i + 1]) for _, sizes, _ in towers
              for i in range(len(sizes) - 1)]
    total = sum(fi * fo + fo for fi, fo in shapes)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    layers, pos = [], 0
    for fi, fo in shapes:
        w = u[pos:pos + fi * fo].view(fi, fo)
        pos += fi * fo
        b = u[pos:pos + fo]
        pos += fo
        wb, bb = (6.0 / fi) ** 0.5, 1.0 / fi ** 0.5
        layers.append({"w": w * (2 * wb) - wb, "b": b * (2 * bb) - bb})
    out, at = {}, 0
    for name, sizes, _ in towers:
        n = len(sizes) - 1
        out[name] = {"layers": layers[at:at + n]}
        at += n
    return {"prop": out["prop"],
            "nerf": {k: out[k] for k in ("trunk", "density", "rgb")}}


def noise_generator(seed: int, device) -> torch.Generator:
    """The generator both sides draw a training run's sampling noise from."""
    return torch.Generator(device).manual_seed(stream_seed(seed, 2))


def leaves(tree) -> list:
    """The tensors of a params tree in a fixed order (sorted keys, layers
    in order, ``b`` before ``w``), with their paths."""
    if isinstance(tree, dict):
        return [(f"{k}.{p}" if p else k, x) for k in sorted(tree)
                for p, x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}.{p}" if p else str(i), x) for i, v in enumerate(tree)
                for p, x in leaves(v)]
    return [("", tree)]
