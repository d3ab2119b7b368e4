"""Plain PyTorch Zip-NeRF, as the ``garden_zip`` configuration runs it: two
proposal rounds and the NeRF level, each with its own multiresolution hash
grid and MLP, on multisampled, contracted, downweighted points; the losses
of the joint cadence and AdamW under the log-lerp schedule.

Float32 throughout, with TF32 off (``model.strict_float32``), and no kernel,
cache or batching of the program. The grid is looked up by indexing: for
each level and each of a cell's 8 corners, its index (dense, or the
Instant-NGP hash in 32-bit arithmetic) and trilinear weight are formed
corner by corner, and the table is gathered at them; autograd gives the
tables' gradients. The lookups run in blocks of rays under
``torch.utils.checkpoint`` (recomputed in the backward), so that a step of
2^16 rays fits the card. It takes the repo's references (``model.py``,
``paper_model.py``) for what the layouts share: the sampling in disparity,
the resampling, alpha compositing, the view-direction features, the losses,
the learning rate and the matrix-product precisions.

The model (Barron et al., "Zip-NeRF", ICCV 2023,
https://arxiv.org/abs/2304.06706; camp_zipnerf ``configs/zipnerf/360.gin``):

- each interval [t0, t1] of a cone ray of radius r as 6 points: t_j (j =
  0..5) = t0 + t_d (t1^2 + 2 t_m^2 + 3/sqrt(7) (2j/5 - 1) sqrt((t_d^2 -
  t_m^2)^2 + 4 t_m^4)) / (t_d^2 + 3 t_m^2) (t_m, t_d the interval's middle
  and half-width), at angle theta_j = pi/3 [0, 2, 4, 3, 5, 1]_j around the
  ray, r t_j / sqrt(2) off its axis along (cos theta u + sin theta v), u, v
  the unit basis of Duff et al. (2017) around the unit direction, each an
  isotropic Gaussian of std 0.5 r t_j / sqrt(2). Training turns interval
  i's pattern by 2 pi turn_i and mirrors it (theta -> 5 pi/3 - theta) where
  mirror_i < 0.5, turn and mirror the step's uniforms; the render turns
  every odd interval's by pi/6 and mirrors it;
- contract(x) on each mean; its std times the cube root of the determinant
  of contract's Jacobian at the mean;
- per sampling level a grid of ``grid_levels`` levels, resolutions n_l =
  round(geomspace(grid_min_res, max_res, levels)) over the cube [-2, 2]^3
  mapped to the unit cube, a float32 table of min((n_l + 1)^3,
  2^grid_log2_table) entries a level (dense index x + (n+1)(y + (n+1) z)
  where it fits, else (x ^ 2654435761 y ^ 805459861 z) mod 2^log2), the
  features at each point interpolated trilinearly, scaled by erf(1 /
  sqrt(8 sigma^2 n_l^2)) (sigma the std in the unit cube's units, the
  contracted std / 4) and averaged over the 6 points: levels x features
  inputs, no positional encoding;
- two proposal rounds of 64 samples, each with its own grid (1 feature a
  level, to resolution 512, then 2,048) and MLP (10 -> 64 ReLU -> raw
  density), the second resampled from the first's histogram; 32 NeRF
  samples with its grid (4 features a level, to 8,192) and MLP (40 -> 64
  ReLU -> a linear 256-wide bottleneck, whose channel 0 is the raw
  density), then the bottleneck and the 27 view-direction features -> 256
  -> 256 (ReLU) -> rgb (sigmoid).

Departures from the published description that the configuration keeps,
and this reference with it: sampling evenly in disparity (Zip-NeRF: a power
transformation); the repo's distillation hinge and distortion loss (per-ray
mean times 0.64) and the training loss 30 - PSNR (Zip-NeRF: its blurred
interlevel loss, the Charbonnier data loss and distortion times 0.01); no
normalised weight decay on the grids (AdamW's 1e-5 on every parameter);
AdamW's beta2 0.999 and eps 1e-8 (the release: 0.99 and 1e-15);
``density_bias`` -5, ``rgb_padding`` 0.001 and the repo's blurred, padded
resampling (``resample_padding`` 0.01) with its stratified jitter; no
``scale_featurization``; the learning-rate delay at 0.01 of the rate; the
points' basis around the ray's own direction (Zip-NeRF: around the
camera's, from a random vector).

``matmul``: as in ``model.py``, forward and backward alike, on the MLPs'
products. ``downweight=False`` leaves the scaling by erf out (omega = 1), a
fault for the control runs.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import model as ref
from . import paper_model as paper
# drivers/train.py reads these two through this module
from .model import strict_float32, to_device  # noqa: F401

POINTS = 6
ANGLES = (0, 2, 4, 3, 5, 1)
PRIMES = (1, 2654435761, 805459861)
# Points a block of the lookups takes (each block under checkpoint).
BLOCK_POINTS = 1 << 20


def intervals(model: dict) -> List[int]:
    """Samples of each sampling level: each proposal round's, the NeRF
    level's."""
    return [model["num_samples"]] * model["proposal_rounds"] + [
        model["nerf_samples"]]


def grid_levels(model: dict, level: int
                ) -> Tuple[List[Tuple[int, int, int, bool]], int]:
    """([(resolution, table size, first entry, dense)] of each grid level,
    features an entry) of sampling level ``level``."""
    max_res = int(str(model["grid_max_res"]).split(",")[level])
    feats = int(str(model["grid_features"]).split(",")[level])
    res = np.round(np.geomspace(model["grid_min_res"], max_res,
                                model["grid_levels"])).astype(np.int64)
    out, first = [], 0
    for n in res.tolist():
        dense = (n + 1) ** 3 <= 2 ** model["grid_log2_table"]
        size = (n + 1) ** 3 if dense else 2 ** model["grid_log2_table"]
        out.append((n, size, first, dense))
        first += size
    return out, feats


def cast(rays, t, pattern=None):
    """Means [B, n, 6, 3] and stds [B, n, 6] of the 6 points of each
    interval of ``t`` [B, n + 1]; ``pattern``: (turn, mirror) [B, n], or
    None for the render's pattern."""
    t0, t1 = t[:, :-1, None], t[:, 1:, None]
    tm, td = 0.5 * (t0 + t1), 0.5 * (t1 - t0)
    j = torch.arange(POINTS, dtype=t.dtype, device=t.device)
    c = (3.0 / math.sqrt(7.0)) * (2.0 * j / 5.0 - 1.0)
    tj = t0 + td * (t1 * t1 + 2.0 * tm * tm + c * torch.sqrt(
        (td * td - tm * tm) ** 2 + 4.0 * tm ** 4)) / (td * td + 3.0 * tm * tm)
    base = torch.tensor(ANGLES, dtype=t.dtype, device=t.device) * math.pi / 3
    if pattern is None:
        odd = (torch.arange(t.shape[1] - 1, device=t.device) % 2)[:, None]
        theta = torch.where(odd == 1, 5 * math.pi / 3 - (base + math.pi / 6),
                            base).expand_as(tj)
    else:
        turn, mirror = pattern
        theta = base + 2 * math.pi * turn[..., None]
        theta = torch.where(mirror[..., None] < 0.5, 5 * math.pi / 3 - theta,
                            theta)
    d = rays["directions"]
    n = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    sgn = torch.where(n[:, 2:] >= 0, 1.0, -1.0)
    a = -1.0 / (sgn + n[:, 2:])
    b = n[:, :1] * n[:, 1:2] * a
    u = torch.cat([1 + sgn * n[:, :1] ** 2 * a, sgn * b, -sgn * n[:, :1]], -1)
    v = torch.cat([b, sgn + n[:, 1:2] ** 2 * a, -n[:, 1:2]], -1)
    radius = rays["radii"][:, :, None] * tj / math.sqrt(2.0)    # [B, n, 6]
    means = (rays["origins"][:, None, None, :]
             + tj[..., None] * d[:, None, None, :]
             + radius[..., None] * (torch.cos(theta)[..., None] * u[:, None, None]
                                    + torch.sin(theta)[..., None]
                                    * v[:, None, None]))
    return means, 0.5 * radius


def contract(means, stds):
    """contract() of each mean [..., 3]; each std [...] times the cube root
    of the determinant of contract's Jacobian there (from the 3x3 matrix)."""
    n2 = (means * means).sum(-1, keepdim=True)
    n = torch.sqrt(torch.clamp(n2, min=1e-10))
    xhat = means / n
    eye = torch.eye(3, dtype=means.dtype, device=means.device)
    outer = xhat[..., :, None] * xhat[..., None, :]
    jac = ((2 * n - 1) / n**2)[..., None] * (eye - outer) + (1 / n**2)[
        ..., None] * outer
    det = torch.linalg.det(jac)
    inside = n2[..., 0] <= 1.0
    new = torch.where(inside[..., None], means, (2 - 1 / n) * xhat)
    return new, stds * torch.where(inside, torch.ones_like(det),
                                   torch.clamp(det, min=0.0) ** (1.0 / 3.0))


def _lookup(table, pos, su, levels, feats, downweight: bool):
    """Every level's downweighted features [P, levels * feats] of unit-cube
    points ``pos`` [P, 3] with unit-cube stds ``su`` [P], corner by corner."""
    out = []
    for n, size, first, dense in levels:
        x = torch.clamp(pos, 0.0, 1.0) * n
        lo = torch.clamp(torch.floor(x), 0, n - 1)
        frac = x - lo
        lo = lo.long()
        acc = 0.0
        for corner in range(8):
            bit = [(corner >> k) & 1 for k in range(3)]
            xyz = [lo[:, k] + bit[k] for k in range(3)]
            w = torch.ones_like(frac[:, 0])
            for k in range(3):
                w = w * (frac[:, k] if bit[k] else 1.0 - frac[:, k])
            if dense:
                idx = xyz[0] + (n + 1) * xyz[1] + (n + 1) ** 2 * xyz[2]
            else:
                h = ((xyz[0] * PRIMES[0]) % 2**32 ^ (xyz[1] * PRIMES[1]) % 2**32
                     ^ (xyz[2] * PRIMES[2]) % 2**32)
                idx = h % size
            acc = acc + w[:, None] * table[first + idx]
        if downweight:
            acc = acc * torch.erf(1.0 / torch.sqrt(8.0 * su**2 * n**2))[:, None]
        out.append(acc)
    return torch.cat(out, -1)


def grid_encode(model: dict, level: int, table, rays, t, pattern=None,
                downweight: bool = True):
    """Sampling level ``level``'s MLP input [B, n, levels * features]: the
    mean over each interval's 6 points of their downweighted grid
    features."""
    levels, feats = grid_levels(model, level)
    b, n = t.shape[0], t.shape[1] - 1
    per = max(1, BLOCK_POINTS // (n * POINTS))

    def block(table, t, origins, directions, radii, *pat):
        part = {"origins": origins, "directions": directions, "radii": radii}
        with torch.no_grad():
            means, stds = contract(*cast(part, t, pat or None))
            pos, su = (means + 2.0) / 4.0, stds / 4.0
        f = _lookup(table, pos.reshape(-1, 3), su.reshape(-1), levels, feats,
                    downweight)
        return f.view(t.shape[0], n, POINTS, -1).mean(2)

    outs = []
    for lo in range(0, b, per):
        sl = slice(lo, lo + per)
        args = [table, t[sl], rays["origins"][sl], rays["directions"][sl],
                rays["radii"][sl]]
        if pattern is not None:
            args += [pattern[0][sl], pattern[1][sl]]
        if torch.is_grad_enabled() and table.requires_grad:
            outs.append(checkpoint(block, *args, use_reentrant=False))
        else:
            outs.append(block(*args))
    return torch.cat(outs)


def draw_noise(gen: torch.Generator, batch: int, model: dict):
    """``paper_model.draw_noise``'s uniforms, then the patterns' [B, 2 M]
    in [0, 1) (M the intervals of all levels; each level in order takes
    [B, n] turns, then [B, n] mirrors)."""
    first, jitter = paper.draw_noise(gen, batch, model)
    m = sum(intervals(model))
    turns = torch.rand((batch, 2 * m), generator=gen, device=gen.device,
                       dtype=torch.float32)
    return first, jitter, turns


def patterns(model: dict, noise):
    """Each sampling level's (turn, mirror) of a step's noise, or Nones."""
    if noise is None:
        return [None] * (model["proposal_rounds"] + 1)
    out, lo = [], 0
    for n in intervals(model):
        p = noise[2]
        out.append((p[:, lo:lo + n], p[:, lo + n:lo + 2 * n]))
        lo += 2 * n
    return out


def forward(model: dict, params, rays, noise=None, matmul: str = "float32",
            downweight: bool = True):
    """Every level. ``noise``: (proposal edges [B, n + 1], each later
    round's and then the NeRF level's resample jitter, the patterns) for a
    training step, None for the deterministic render. Returns the proposal
    rounds' [(t, w)] and the NeRF level's t, w, rgb, distance, acc."""
    mm = ref._matmul_fn(matmul)
    n, pad = model["num_samples"], model["resample_padding"]
    near, far, d = rays["near"], rays["far"], rays["directions"]
    first, jitters, last = paper.noise_parts(
        model, None if noise is None else noise[:2])
    pats = patterns(model, noise)
    t = ref.sample_edges(near, far, n, first)
    props = []
    for r in range(model["proposal_rounds"]):
        if r:
            t = paper.resample(t, props[-1][1].detach(), pad, n + 1,
                               jitters[r - 1])
        mlp = params["prop"][r]
        x = grid_encode(model, r, mlp["grid"], rays, t, pats[r], downweight)
        raw = ref.mlp(mlp["layers"], x, ["relu", "none"], mm)
        props.append((t, ref.alpha_weights(
            ref._softplus(raw[..., 0] + model["density_bias"]), t, d)))
    t_n = paper.resample(t, props[-1][1].detach(), pad,
                         model["nerf_samples"] + 1, last)
    nerf = params["nerf"]
    x = grid_encode(model, model["proposal_rounds"], nerf["grid"], rays, t_n,
                    pats[-1], downweight)
    h = ref.mlp(nerf["trunk"]["layers"], x, ["relu"], mm)
    y = ref.mlp(nerf["bottleneck"]["layers"], h, ["none"], mm)
    dens = ref._softplus(y[..., 0] + model["density_bias"])
    view = paper.direction_features(model, rays["viewdirs"])
    branch = torch.cat([y, view[:, None, :].expand(*y.shape[:2],
                                                   view.shape[-1])], -1)
    rgb = ref.mlp(nerf["rgb"]["layers"], branch,
                  ["relu"] * model["viewdir_depth"] + ["sigmoid"], mm)
    p = model["rgb_padding"]
    rgb = rgb * (1 + 2 * p) - p
    w = ref.alpha_weights(dens, t_n, d)
    comp = (w[..., None] * rgb).sum(-2)
    acc = w.sum(-1)
    mids = 0.5 * (t_n[:, 1:] + t_n[:, :-1])
    dist = torch.nan_to_num((w * mids).sum(-1) / acc, nan=0.0)
    dist = torch.minimum(torch.maximum(dist, t_n[:, 0]), t_n[:, -1])
    if model["white_bkgd"]:
        comp = comp + (1 - acc[..., None])
    return {"props": props, "t": t_n, "w": w, "rgb": comp, "distance": dist,
            "acc": acc}


def losses(train: dict, out, pixels, near, far) -> Dict[str, torch.Tensor]:
    """``paper_model.losses``: every round's distillation hinge."""
    return paper.losses(train, out, pixels, near, far)


def train_steps(model: dict, train: dict, params0, batches, gen,
                matmul: str = "float32", drop_half: bool = False,
                downweight: bool = True):
    """``paper_model.train_steps`` with this layout: ``len(batches)``
    joint-cadence AdamW steps from ``params0`` (not changed). Returns
    {"losses": [per step {name: float}], "grad1": {path: first step's
    gradient}, "params": {path: params after the last step}}."""
    from ..weights import leaves

    tree = ref._map(lambda p: p.detach().clone().requires_grad_(), params0)
    named = leaves(tree)
    mu = [torch.zeros_like(p) for _, p in named]
    nu = [torch.zeros_like(p) for _, p in named]
    out = {"losses": [], "grad1": {}, "params": {}}
    for k, (rays, pixels) in enumerate(batches):
        noise = draw_noise(gen, pixels.shape[0], model)
        if drop_half:
            h = pixels.shape[0] // 2
            rays = {n_: v[:h] for n_, v in rays.items()}
            pixels, noise = pixels[:h], tuple(x[:h] for x in noise)
        fwd = forward(model, tree, rays, noise, matmul, downweight)
        ls = losses(train, fwd, pixels, rays["near"], rays["far"])
        grads = torch.autograd.grad(ls["loss"], [p for _, p in named])
        out["losses"].append({n_: float(v.detach()) for n_, v in ls.items()})
        del fwd, ls
        if k == 0:
            out["grad1"] = {n_: g.detach().clone()
                            for (n_, _), g in zip(named, grads)}
        lr = ref.learning_rate(train, k)
        c = k + 1
        bc1 = float(np.float32(1) - np.float32(ref.B1) ** np.float32(c))
        bc2 = float(np.float32(1) - np.float32(ref.B2) ** np.float32(c))
        with torch.no_grad():
            for (_, p), g, m1, m2 in zip(named, grads, mu, nu):
                m1.mul_(ref.B1).add_((1 - ref.B1) * g)
                m2.mul_(ref.B2).add_((1 - ref.B2) * g * g)
                u = ((m1 / bc1) / (torch.sqrt(m2 / bc2) + ref.ADAM_EPS)
                     + train["weight_decay"] * p)
                p -= lr * u
        del grads
    out["params"] = {n_: p.detach().clone() for n_, p in named}
    return out


@torch.no_grad()
def render(model: dict, params, rays, block: int = 8192,
           matmul: str = "float32"):
    """The deterministic render of ``rays`` (dict of [n, c]) in blocks:
    {"rgb" [n, 3], "distance" [n], "acc" [n]}."""
    n = rays["origins"].shape[0]
    outs = {"rgb": [], "distance": [], "acc": []}
    for lo in range(0, n, block):
        part = {k: v[lo:lo + block] for k, v in rays.items()}
        o = forward(model, params, part, None, matmul)
        for k in outs:
            outs[k].append(o[k])
    return {k: torch.cat(v) for k, v in outs.items()}
