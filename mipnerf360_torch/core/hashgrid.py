"""The multiresolution hash grid of Zip-NeRF's encode (Instant-NGP's
tables), in plain PyTorch: the levels' layout, the corner indices and
trilinear weights, and the downweighted lookup. The JAX package has no
grid; ``ops/hashgrid.py`` dispatches between this and the kernels.

A sampling level's grid is one float32 table [entries, features]: its
levels' tables one after another. Level l has resolution n_l (geometric
from ``min_res`` to ``max_res``, rounded) and covers the contracted ball's
cube [-2, 2]^3 as the unit cube of n_l cells a side. A point's cell is
looked up at its 8 corners, each corner's entry at its dense index x + (n_l
+ 1)(y + (n_l + 1) z) where the (n_l + 1)^3 corners fit the table size T,
else at its hash (x ^ 2654435761 y ^ 805459861 z) mod T in 32-bit
arithmetic, and the entries are interpolated trilinearly. Each point's
features at level l are scaled by omega = erf(1 / sqrt(8 sigma^2 n_l^2)),
sigma its std in the unit cube's units (the contracted std / 4), and
averaged over the ``MULTISAMPLES`` points of a sample.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)
BOX = 2.0    # the contracted ball lies in [-BOX, BOX]^3


class GridSpec(NamedTuple):
    """One sampling level's grid: each level's resolution, table size and
    first entry, and the features an entry."""

    resolutions: Tuple[int, ...]
    sizes: Tuple[int, ...]
    offsets: Tuple[int, ...]
    features: int
    log2_table: int

    @property
    def entries(self) -> int:
        return self.offsets[-1] + self.sizes[-1]

    @property
    def width(self) -> int:
        """Features of the encode: levels x features."""
        return len(self.resolutions) * self.features


def grid_spec(min_res: int, max_res: int, levels: int, log2_table: int,
              features: int) -> GridSpec:
    """The layout of one sampling level's grid."""
    res = tuple(int(n) for n in np.round(np.geomspace(min_res, max_res,
                                                      levels)))
    table = 2 ** log2_table
    sizes = tuple(min((n + 1) ** 3, table) for n in res)
    offsets = tuple(int(x) for x in np.cumsum((0,) + sizes[:-1]))
    return GridSpec(res, sizes, offsets, features, log2_table)


def model_grid_spec(cfg, level: int) -> GridSpec:
    """Sampling level ``level``'s grid of a ``ModelConfig`` (0: the first
    proposal round; ``proposal_rounds``: the NeRF level)."""
    return grid_spec(cfg.grid_min_res, cfg.grid_resolutions[level],
                     cfg.grid_levels, cfg.grid_log2_table,
                     cfg.grid_level_features[level])


def corners(pos, n: int, size: int, log2_table: int):
    """The 8 corners of the cells of unit-cube points ``pos`` [P, 3] at
    resolution ``n``: indices [P, 8] into the level's table (int64) and
    trilinear weights [P, 8], corner c at offset (c & 1, c >> 1 & 1, c >> 2
    & 1)."""
    x = torch.clamp(pos, 0.0, 1.0) * n
    i0 = torch.clamp(torch.floor(x), 0, n - 1)
    f = x - i0
    i0 = i0.long()
    bits = torch.tensor([[(c >> k) & 1 for k in range(3)] for c in range(8)],
                        device=pos.device)                     # [8, 3]
    ic = i0[:, None, :] + bits                                 # [P, 8, 3]
    w = torch.where(bits.bool(), f[:, None, :], 1.0 - f[:, None, :]).prod(-1)
    if (n + 1) ** 3 <= 2 ** log2_table:
        idx = ic[..., 0] + (n + 1) * (ic[..., 1] + (n + 1) * ic[..., 2])
    else:
        idx = ((ic[..., 0] * PRIMES[0]) ^ (ic[..., 1] * PRIMES[1])
               ^ (ic[..., 2] * PRIMES[2])) & (size - 1)
    return idx, w


def unit_points(means, stds):
    """Contracted means [..., 3] and stds [...] in the unit cube's units."""
    return (means + BOX) / (2.0 * BOX), stds / (2.0 * BOX)


def downweights(stds_unit, spec: GridSpec):
    """omega [P, levels] of points with unit-cube stds [P]."""
    n = torch.tensor(spec.resolutions, dtype=stds_unit.dtype,
                     device=stds_unit.device)
    return torch.special.erf(1.0 / torch.sqrt(8.0 * stds_unit[:, None]**2
                                              * n**2))


def lookups(pos, stds_unit, spec: GridSpec):
    """Every level's corners of points ``pos`` [P, 3] with unit-cube stds
    [P]: entries [P, levels, 8] into the whole table and weights [P,
    levels, 8], each the corner's trilinear weight times the point's
    downweight at that level."""
    omega = downweights(stds_unit, spec)
    idx, wts = [], []
    for level, (n, size, off) in enumerate(zip(spec.resolutions, spec.sizes,
                                               spec.offsets)):
        i, w = corners(pos, n, size, spec.log2_table)
        idx.append(i + off)
        wts.append(w * omega[:, level, None])
    return torch.stack(idx, 1), torch.stack(wts, 1)


def plain_features(table, pos, stds_unit, spec: GridSpec, points: int):
    """The encode of samples of ``points`` points each: ``pos`` [S * points,
    3] and ``stds_unit`` [S * points] -> [S, levels * features], each
    level's downweighted features averaged over the points."""
    idx, w = lookups(pos, stds_unit, spec)
    feats = (table[idx] * w[..., None]).sum(-2)          # [P, levels, F]
    return feats.view(-1, points, spec.width).mean(1)


def plain_table_grad(g, pos, stds_unit, spec: GridSpec, points: int):
    """The gradient of :func:`plain_features`'s sum against ``g`` [S,
    levels * features] for its table, by ``index_add_``: each corner's
    entry takes g omega w / points."""
    idx, w = lookups(pos, stds_unit, spec)
    gp = (g.float() / points).view(-1, 1, len(spec.resolutions),
                                   spec.features)
    gp = gp.expand(-1, points, -1, -1).reshape(-1, len(spec.resolutions), 1,
                                               spec.features)
    out = torch.zeros((spec.entries, spec.features), dtype=torch.float32,
                      device=g.device)
    out.index_add_(0, idx.reshape(-1), (w[..., None] * gp).reshape(
        -1, spec.features))
    return out
