"""Plain PyTorch Mip-NeRF 360 with the published network, as the
``garden_paper`` configuration runs it: two proposal rounds through one
proposal MLP, the NeRF level with the trunk's skip, the density head, the
bottleneck and the view branch, the losses of the joint cadence and AdamW
under the log-lerp schedule.

Float32 throughout, with TF32 off (``model.strict_float32``), and no kernel,
cache or batching of the program. It takes the repo's own reference
(``model.py``) for what the two layouts share: the sampling in disparity,
the general Gaussian encode (its point features only), alpha compositing,
the learning rate, the matrix-product precisions and the distortion and
distillation terms. The MLPs are written out here: the skip as a
concatenation of the hidden features and the input and one product, the
view layer as one product of the bottleneck concatenated with the
direction encoding of each sample.

The layout (Barron et al. 2022; multinerf ``configs/360.gin`` and its
``MLP`` defaults): 42 x 12 IPE features without view directions; the
trunk's input concatenated after its fifth layer; a density head and a
linear 256-wide bottleneck on the trunk; the unit view direction, sin of
its coordinates at 2^0..2^3 and sin of the same plus pi/2 (27 features)
beside the bottleneck into one 128-wide ReLU layer and the rgb head; 64
samples a proposal round, the second resampled from the first's histogram,
and 32 NeRF samples resampled from the second's; the distillation loss of
both rounds.

Departures from the published description that the configuration keeps,
and this reference with it: the 21 basis directions of the repo's encode
(multinerf's subdivided icosahedron gives as many) and its contraction of
the Gaussians by their Jacobian; the training loss 30 - PSNR (not the
published data loss on the pixels); the distortion loss as a per-ray mean
times ``dist_loss_weight`` 0.64 (multinerf: 0.01); the distillation hinge
sum(relu(bound - w)^2 / (w + 1e-6)) per ray, the bound summed over the
NeRF intervals that overlap each proposal interval, under stop-gradient;
the resampling from the repo's blurred and padded histogram (max of each
bin's neighbours, averaged, plus ``resample_padding`` 0.01) with its
stratified jitter (not multinerf's annealed, dilated histogram and single
jitter); ``density_bias`` -5 before the softplus; the learning-rate
schedule and AdamW of the repo's quality presets.

``matmul``: as in ``model.py``, forward and backward alike.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import model as ref
# drivers/train.py reads these two through this module
from .model import strict_float32, to_device  # noqa: F401

F32_EPS = ref.F32_EPS


def point_features(model: dict, rays, t):
    """The IPE features [B, n, 42 * scales] of the intervals ``t``."""
    scales = model["ipe_max_deg"] - model["ipe_min_deg"]
    return ref.encode(model, rays, t)[..., :42 * scales]


def direction_features(model: dict, viewdirs):
    """[B, 3 + 6 * scales]: the unit direction, sin(2^i v) over the scales
    (scale-major), sin(2^i v + pi/2)."""
    s = torch.tensor([2.0**i for i in range(model["viewdir_min_deg"],
                                            model["viewdir_max_deg"])],
                     dtype=viewdirs.dtype, device=viewdirs.device)
    x = (viewdirs[:, None, :] * s[:, None]).reshape(viewdirs.shape[0], -1)
    return torch.cat([viewdirs, torch.sin(torch.cat([x, x + 0.5 * math.pi],
                                                    -1))], -1)


@torch.no_grad()
def resample(t, w, padding: float, m: int, noise=None):
    """``m`` new edges from the histogram of ``w`` on the edges ``t``: the
    blurred, padded histogram's inverse CDF at stratified u (``noise`` [B,
    m] in [0, 1/m - eps) on i/m) or at linspace(0, 1 - eps, m)."""
    n = t.shape[-1]
    wp = torch.cat([w[:, :1], w, w[:, -1:]], -1)
    wmax = torch.maximum(wp[:, :-1], wp[:, 1:])
    wb = 0.5 * (wmax[:, :-1] + wmax[:, 1:]) + padding
    ws = wb.sum(-1, keepdim=True)
    pad = torch.clamp(1e-5 - ws, min=0.0)
    wb, ws = wb + pad / wb.shape[-1], ws + pad
    cdf = torch.clamp(torch.cumsum(wb / ws, -1)[:, :-1], max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf,
                     torch.ones_like(cdf[:, :1])], -1)
    if noise is None:
        u = torch.linspace(0.0, 1.0 - F32_EPS, m, dtype=t.dtype,
                           device=t.device).expand(t.shape[0], m)
    else:
        u = torch.arange(m, dtype=t.dtype, device=t.device) / m + noise
        u = torch.clamp(u, max=1.0 - F32_EPS)
    u = u.contiguous()
    hi = torch.searchsorted(cdf.contiguous(), u, right=True)
    i0 = torch.clamp(hi - 1, 0, n - 1)
    i1 = torch.clamp(hi, max=n - 1)
    c0, c1 = cdf.gather(-1, i0), cdf.gather(-1, i1)
    b0, b1 = t.gather(-1, i0), t.gather(-1, i1)
    frac = torch.clamp(torch.nan_to_num((u - c0) / (c1 - c0), nan=0.0), 0.0, 1.0)
    return b0 + frac * (b1 - b0)


def _linear(layer, x, mm):
    lead = x.shape[:-1]
    y = mm(x.reshape(-1, x.shape[-1]), layer["w"]) + layer["b"]
    return y.reshape(*lead, y.shape[-1])


def _density(model, raw):
    return ref._softplus(raw[..., 0] + model["density_bias"])


def noise_parts(model: dict, noise):
    """(first round's edge jitter, each later round's resample jitter, the
    NeRF level's) of a step's noise (None for none)."""
    rounds = model["proposal_rounds"]
    if noise is None:
        return None, [None] * (rounds - 1), None
    k = model["num_samples"] + 1
    r = noise[1]
    return (noise[0], [r[:, i * k:(i + 1) * k] for i in range(rounds - 1)],
            r[:, (rounds - 1) * k:])


def forward(model: dict, params, rays, noise=None, matmul: str = "float32"):
    """Every level. ``noise``: (proposal edges [B, n + 1], each later
    round's and then the NeRF level's resample jitter along the last axis)
    for a training step, None for the deterministic render. Returns the
    proposal rounds' [(t, w)] and the NeRF level's t, w, rgb, distance,
    acc."""
    mm = ref._matmul_fn(matmul)
    acts_p, acts_t, acts_d = ref._acts(model)
    n, pad = model["num_samples"], model["resample_padding"]
    near, far, d = rays["near"], rays["far"], rays["directions"]
    first, jitters, last = noise_parts(model, noise)
    t = ref.sample_edges(near, far, n, first)
    props = []
    for r in range(model["proposal_rounds"]):
        if r:
            t = resample(t, props[-1][1].detach(), pad, n + 1, jitters[r - 1])
        with torch.no_grad():
            x = point_features(model, rays, t)
        w = ref.alpha_weights(
            _density(model, ref.mlp(params["prop"]["layers"], x, acts_p, mm)),
            t, d)
        props.append((t, w))
    t_n = resample(t, props[-1][1].detach(), pad, model["nerf_samples"] + 1,
                   last)
    with torch.no_grad():
        x = point_features(model, rays, t_n)
    nerf = params["nerf"]
    skips = set(i + 1 for i in range(1, model["nerf_depth"] - 1)
                if i % model["trunk_skip"] == 0)
    h = x
    for i, (layer, act) in enumerate(zip(nerf["trunk"]["layers"], acts_t)):
        if i in skips:
            h = torch.cat([h, x], -1)
        h = ref.ACTS[act](_linear(layer, h, mm))
    dens = _density(model, ref.mlp(nerf["density"]["layers"], h, acts_d, mm))
    bottleneck = _linear(nerf["bottleneck"]["layers"][0], h, mm)
    view = direction_features(model, rays["viewdirs"])
    branch = torch.cat([bottleneck, view[:, None, :].expand(
        *bottleneck.shape[:2], view.shape[-1])], -1)
    rgb = ref.mlp(nerf["rgb"]["layers"], branch, ["relu", "sigmoid"], mm)
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


def _hinge(tf, wf, tc, wc):
    """The distillation hinge of one proposal round, summed over the batch:
    the bound of each of its intervals is the NeRF weights of the
    intervals that overlap it."""
    overlap = ~((tf[:, None, :-1] > tc[:, 1:, None])
                | (tf[:, None, 1:] < tc[:, :-1, None]))
    bound = (overlap.float() * wf[:, None, :]).sum(-1)
    return (torch.clamp(bound - wc, min=0.0) ** 2 / (wc + 1e-6)).sum()


def losses(train: dict, out, pixels, near, far) -> Dict[str, torch.Tensor]:
    """``model.losses`` of the first round, with the distillation hinge of
    every later round added to ``loss_prop`` and ``loss``."""
    (t1, w1), rest = out["props"][0], out["props"][1:]
    parts = ref.losses(train, dict(out, t_prop=t1, w_prop=w1), pixels, near,
                       far)
    b = pixels.shape[0]
    for tc, wc in rest:
        extra = _hinge(out["t"].detach(), out["w"].detach(), tc, wc) / b
        parts["loss_prop"] = parts["loss_prop"] + extra
        parts["loss"] = parts["loss"] + extra
    return parts


def draw_noise(gen: torch.Generator, batch: int, model: dict):
    """The uniforms of one training step, in the order the step draws them:
    the first round's edge jitter [B, n + 1] in [0, 1), each later round's
    resample jitter [B, n + 1] in [0, 1/(n + 1) - eps), then the NeRF
    level's [B, m + 1] in [0, 1/(m + 1) - eps); the jitters concatenated."""
    def uniform(k):
        return torch.rand((batch, k), generator=gen, device=gen.device,
                          dtype=torch.float32)

    n, m = model["num_samples"] + 1, model["nerf_samples"] + 1
    first = uniform(n)
    sizes = [n] * (model["proposal_rounds"] - 1) + [m]
    jitter = [uniform(k) * float(np.float32(1.0 / k) - F32_EPS) for k in sizes]
    return first, torch.cat(jitter, -1)


def train_steps(model: dict, train: dict, params0, batches, gen,
                matmul: str = "float32", drop_half: bool = False):
    """``model.train_steps`` with this layout: ``len(batches)``
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
            pixels, noise = pixels[:h], (noise[0][:h], noise[1][:h])
        fwd = forward(model, tree, rays, noise, matmul)
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
