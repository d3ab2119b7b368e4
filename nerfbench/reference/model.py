"""Plain PyTorch Mip-NeRF 360, as the configurations run it: the
proposal level and the NeRF level, the losses of the joint cadence and
AdamW under the log-lerp schedule.

Float32 throughout, with TF32 off (:func:`strict_float32`), and no kernel,
cache or batching of the program: sampling in disparity, the general
Gaussian path (frustum moments lifted to 3x3 covariances, pushed through
the contraction by its Jacobian, then projected on the 21 directions of
the paper's basis), the MLPs as matrix products, alpha compositing, the
blurred inverse-CDF resampling, the distortion loss in its quadratic form
and the distillation bound from the full overlap mask.

Departures from the paper that are the configurations' own and are kept
here as they run: one proposal round of ``num_samples`` samples; the MLP
layout of the repo's model, with no skip connection in the trunk, no
bottleneck or view-direction branch (the density and rgb heads read the
trunk's output), and the view directions in the trunk's input, encoded as
theta = arccos z, phi = arctan(y / (x + 1e-6)), sines and cosines of both
at 2^i; the training loss 30 - PSNR; and the per-ray mean of the
distortion loss times ``dist_loss_weight``.

``matmul`` selects the precision of the matrix products: ``"float32"``
(the reference), ``"bfloat16"``, or ``"float8"`` (e4m3 operands with a
scale per tensor, products summed in float32; the control one precision
below the configurations' bfloat16), forward and backward alike.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

F32_EPS = float(np.finfo(np.float32).eps)
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
E4M3_MAX = 448.0

# The 21 directions of the paper's encoding basis (icosahedron vertices
# and edge midpoints on one hemisphere).
BASIS = [
    [0.8506508, 0.0, 0.5257311], [0.809017, 0.5, 0.309017],
    [0.5257311, 0.8506508, 0.0], [1.0, 0.0, 0.0],
    [0.809017, 0.5, -0.309017], [0.8506508, 0.0, -0.5257311],
    [0.309017, 0.809017, -0.5], [0.0, 0.5257311, -0.8506508],
    [0.5, 0.309017, -0.809017], [0.0, 1.0, 0.0],
    [-0.5257311, 0.8506508, 0.0], [-0.309017, 0.809017, -0.5],
    [0.0, 0.5257311, 0.8506508], [-0.309017, 0.809017, 0.5],
    [0.309017, 0.809017, 0.5], [0.5, 0.309017, 0.809017],
    [0.5, -0.309017, 0.809017], [0.0, 0.0, 1.0],
    [-0.5, 0.309017, 0.809017], [-0.809017, 0.5, 0.309017],
    [-0.809017, 0.5, -0.309017],
]


def strict_float32() -> None:
    """No TF32 in float32 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _quantizer(matmul: str):
    if matmul == "float32":
        return None
    if matmul == "bfloat16":
        return lambda x: x.to(torch.bfloat16).float()
    if matmul == "float8":
        def q(x):
            s = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
            return (x / s).to(torch.float8_e4m3fn).float() * s
        return q
    raise ValueError(f"unknown matmul precision {matmul!r}")


class _QuantMatmul(torch.autograd.Function):
    """x @ w with both operands rounded by ``q``; the backward rounds the
    cotangent and the saved operands alike."""

    @staticmethod
    def forward(ctx, x, w, q):
        xq, wq = q(x), q(w)
        ctx.save_for_backward(xq, wq)
        ctx.q = q
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = ctx.q(g)
        return gq @ wq.t(), xq.t() @ gq, None


def _matmul_fn(matmul: str):
    q = _quantizer(matmul)
    if q is None:
        return lambda x, w: x @ w
    return lambda x, w: _QuantMatmul.apply(x, w, q)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid, "none": lambda x: x}


def mlp(layers, x, acts, mm):
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    for layer, act in zip(layers, acts):
        x = ACTS[act](mm(x, layer["w"]) + layer["b"])
    return x.reshape(*lead, x.shape[-1])


def _acts(model: dict):
    final = "sigmoid" if model["trunk_final_sigmoid"] else "relu"
    prop = ["relu"] * (model["proposal_depth"] - 1) + [final, "none"]
    trunk = ["relu"] * (model["nerf_depth"] - 1) + [final]
    dens = ["sigmoid" if model["density_head_sigmoid"] else "none"]
    return prop, trunk, dens


_G_EPS = 1e-6


def _g(x):
    return 1.0 / (x + _G_EPS)


def sample_edges(near, far, n: int, noise=None):
    """n + 1 interval edges per ray, evenly spaced in s = (g(t) - g(near)) /
    (g(far) - g(near)), g(x) = 1 / (x + 1e-6); ``noise`` [B, n + 1] in
    [0, 1) moves each edge uniformly within its stratum."""
    s = torch.linspace(0.0, 1.0, n + 1, dtype=torch.float32, device=near.device)
    t = 1.0 / ((1.0 - s) * _g(near) + s * _g(far)) - _G_EPS     # [B, n+1]
    if noise is None:
        return t
    mids = 0.5 * (t[:, 1:] + t[:, :-1])
    upper = torch.cat([mids, t[:, -1:]], -1)
    lower = torch.cat([t[:, :1], mids], -1)
    return lower + (upper - lower) * noise


def t_to_s(t, near, far):
    return (_g(t) - _g(near)) / (_g(far) - _g(near))


def encode(model: dict, rays: Dict[str, torch.Tensor], t):
    """MLP inputs [B, n, 42 * scales + 4 * view scales] of the intervals
    ``t`` [B, n + 1]: the integrated positional encoding of the contracted
    Gaussian of each interval, then the view-direction encoding."""
    t0, t1 = t[:, :-1], t[:, 1:]
    r = rays["radii"]                                         # [B, 1]
    if model["ray_shape"] == "cone":
        mu, hw = (t0 + t1) / 2, (t1 - t0) / 2
        den = 3 * mu**2 + hw**2
        t_mean = mu + 2 * mu * hw**2 / den
        t_var = hw**2 / 3 - (4 / 15) * hw**4 * (12 * mu**2 - hw**2) / den**2
        r_var = r**2 * (mu**2 / 4 + (5 / 12) * hw**2 - (4 / 15) * hw**4 / den)
    else:
        t_mean, t_var = (t0 + t1) / 2, (t1 - t0) ** 2 / 12
        r_var = (r**2 / 4).expand_as(t_mean)
    d = rays["directions"]
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    ddt = d[:, :, None] * d[:, None, :]                       # [B, 3, 3]
    dn2 = torch.clamp((d * d).sum(-1), min=1e-10)[:, None, None]
    mean = rays["origins"][:, None, :] + d[:, None, :] * t_mean[..., None]
    cov = (t_var[..., None, None] * ddt[:, None]
           + r_var[..., None, None] * (eye - ddt / dn2)[:, None])
    # contraction: x -> (2 - 1/|x|) x/|x| outside the unit ball
    n2 = (mean * mean).sum(-1, keepdim=True)
    n = torch.sqrt(torch.clamp(n2, min=1e-10))
    xhat = mean / n
    a = (2 * n - 1) / n**2
    b = 1 / n**2 - a
    jac = a[..., None] * eye + b[..., None] * xhat[..., :, None] * xhat[..., None, :]
    inside = (n2 <= 1.0)
    jac = torch.where(inside[..., None], eye, jac)
    mean = torch.where(inside, mean, (2 - 1 / n) * xhat)
    cov = jac @ cov @ jac.transpose(-1, -2)
    p = torch.tensor(BASIS, dtype=d.dtype, device=d.device)   # [21, 3]
    phase = mean @ p.t()                                      # [B, n, 21]
    var = torch.einsum("ki,rnij,kj->rnk", p, cov, p)
    feats = []
    for i in range(model["ipe_min_deg"], model["ipe_max_deg"]):
        att = torch.exp(-0.5 * 4.0**i * var)
        feats += [att * torch.sin(2.0**i * phase), att * torch.cos(2.0**i * phase)]
    v = rays["viewdirs"]
    theta = torch.arccos(torch.clamp(v[:, 2:3], -1.0, 1.0))
    den = v[:, 0:1] + 1e-6
    den = torch.where(den == 0, torch.full_like(den, torch.finfo(den.dtype).tiny), den)
    phi = torch.arctan(v[:, 1:2] / den)
    sc = torch.tensor([2.0**i for i in range(model["viewdir_min_deg"],
                                            model["viewdir_max_deg"])],
                      dtype=d.dtype, device=d.device)
    view = torch.cat([torch.sin(theta * sc), torch.cos(theta * sc),
                      torch.sin(phi * sc), torch.cos(phi * sc)], -1)
    pos = torch.cat(feats, -1)
    return torch.cat([pos, view[:, None, :].expand(*pos.shape[:2], view.shape[-1])], -1)


def alpha_weights(density, t, d):
    """w_i = (1 - exp(-sigma_i delta_i)) exp(-sum_{j<i} sigma_j delta_j),
    delta_i the interval's length times |d|."""
    sd = density * (t[:, 1:] - t[:, :-1]) * torch.linalg.norm(d, dim=-1, keepdim=True)
    trans = torch.exp(-torch.cat([torch.zeros_like(sd[:, :1]),
                                  torch.cumsum(sd[:, :-1], -1)], -1))
    return -torch.expm1(-sd) * trans


@torch.no_grad()
def resample(t, w, padding: float, noise=None):
    """t.shape[-1] new edges from the proposal histogram: max of each
    bin's neighbours, averaged, plus ``padding``; inverse CDF at stratified
    u (``noise`` [B, m] in [0, 1/m - eps) on i/m) or at the deterministic
    linspace(0, 1 - eps, m)."""
    m = t.shape[-1]
    wp = torch.cat([w[:, :1], w, w[:, -1:]], -1)
    wmax = torch.maximum(wp[:, :-1], wp[:, 1:])
    wb = 0.5 * (wmax[:, :-1] + wmax[:, 1:]) + padding
    ws = wb.sum(-1, keepdim=True)
    pad = torch.clamp(1e-5 - ws, min=0.0)
    wb, ws = wb + pad / wb.shape[-1], ws + pad
    cdf = torch.clamp(torch.cumsum(wb / ws, -1)[:, :-1], max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf, torch.ones_like(cdf[:, :1])], -1)
    if noise is None:
        u = torch.linspace(0.0, 1.0 - F32_EPS, m, dtype=t.dtype,
                           device=t.device).expand(t.shape[0], m)
    else:
        u = torch.arange(m, dtype=t.dtype, device=t.device) / m + noise
        u = torch.clamp(u, max=1.0 - F32_EPS)
    u = u.contiguous()
    hi = torch.searchsorted(cdf.contiguous(), u, right=True)  # count of cdf <= u
    i0 = torch.clamp(hi - 1, 0, m - 1)
    i1 = torch.clamp(hi, max=m - 1)
    c0, c1 = cdf.gather(-1, i0), cdf.gather(-1, i1)
    b0, b1 = t.gather(-1, i0), t.gather(-1, i1)
    frac = torch.clamp(torch.nan_to_num((u - c0) / (c1 - c0), nan=0.0), 0.0, 1.0)
    return b0 + frac * (b1 - b0)


def forward(model: dict, params, rays, noise=None, matmul: str = "float32"):
    """Both levels. ``noise``: (proposal edges [B, n + 1], resample jitter
    [B, n + 1]) for a training step, None for the deterministic render.
    Returns the proposal's (t, w) and the NeRF level's t, w, rgb, distance,
    acc."""
    mm = _matmul_fn(matmul)
    acts_p, acts_t, acts_d = _acts(model)
    n = model["num_samples"]
    near, far, d = rays["near"], rays["far"], rays["directions"]
    t_p = sample_edges(near, far, n, None if noise is None else noise[0])
    with torch.no_grad():
        x_p = encode(model, rays, t_p)
    dens_p = _softplus(mlp(params["prop"]["layers"], x_p, acts_p, mm)[..., 0]
                       + model["density_bias"])
    w_p = alpha_weights(dens_p, t_p, d)
    t_n = resample(t_p, w_p.detach(), model["resample_padding"],
                   None if noise is None else noise[1])
    with torch.no_grad():
        x_n = encode(model, rays, t_n)
    nerf = params["nerf"]
    feat = mlp(nerf["trunk"]["layers"], x_n, acts_t, mm)
    dens = _softplus(mlp(nerf["density"]["layers"], feat, acts_d, mm)[..., 0]
                     + model["density_bias"])
    pad = model["rgb_padding"]
    rgb = mlp(nerf["rgb"]["layers"], feat, ["sigmoid"], mm) * (1 + 2 * pad) - pad
    w = alpha_weights(dens, t_n, d)
    comp = (w[..., None] * rgb).sum(-2)
    acc = w.sum(-1)
    mids = 0.5 * (t_n[:, 1:] + t_n[:, :-1])
    dist = torch.nan_to_num((w * mids).sum(-1) / acc, nan=0.0)
    dist = torch.minimum(torch.maximum(dist, t_n[:, 0]), t_n[:, -1])
    if model["white_bkgd"]:
        comp = comp + (1 - acc[..., None])
    return {"t_prop": t_p, "w_prop": w_p, "t": t_n, "w": w, "rgb": comp,
            "distance": dist, "acc": acc}


def losses(train: dict, out, pixels, near, far) -> Dict[str, torch.Tensor]:
    """The joint cadence's losses: 30 - PSNR of the batch, the distortion
    loss (per-ray mean, quadratic form) times its weight, and the
    distillation hinge against the bound of the NeRF weights (no gradient
    into the NeRF level)."""
    b = pixels.shape[0]
    mse = ((out["rgb"] - pixels) ** 2).sum() / b
    psnr = -10.0 * torch.log10(mse)
    s = t_to_s(out["t"], near, far)
    w = out["w"]
    m, ds = 0.5 * (s[:, 1:] + s[:, :-1]), s[:, 1:] - s[:, :-1]
    pair = (w[:, :, None] * w[:, None, :] * (m[:, :, None] - m[:, None, :]).abs()).sum((1, 2))
    dist = (pair + (w**2 * ds).sum(-1) / 3).mean()
    if train["dist_loss_reduction"] != "mean":
        raise ValueError("the reference has the per-ray mean distortion only")
    tf, wf = out["t"].detach(), w.detach()
    tc, wc = out["t_prop"], out["w_prop"]
    overlap = ~((tf[:, None, :-1] > tc[:, 1:, None]) | (tf[:, None, 1:] < tc[:, :-1, None]))
    bound = (overlap.float() * wf[:, None, :]).sum(-1)
    prop = (torch.clamp(bound - wc, min=0.0) ** 2 / (wc + 1e-6)).sum() / b
    loss = (30.0 - psnr) + train["dist_loss_weight"] * dist + prop
    return {"loss": loss, "psnr": psnr, "loss_nerf": 30.0 - psnr,
            "loss_dist": dist, "loss_prop": prop}


def learning_rate(train: dict, count: int) -> float:
    """Log-linear from lr_init to lr_final over ``lr_max_steps``, times the
    sine warm-up delay, in float32."""
    f = np.float32
    step = f(count)
    delay = train["lr_delay_steps"]
    rate = f(1.0)
    if delay > 0:
        x = np.clip(step / f(delay), f(0), f(1))
        rate = f(train["lr_delay_mult"]) + (f(1) - f(train["lr_delay_mult"])) * np.sin(
            f(0.5 * math.pi) * x)
    t = np.clip(step / f(train["lr_max_steps"]), f(0), f(1))
    lr = np.exp(np.log(f(train["lr_init"])) * (f(1) - t) + np.log(f(train["lr_final"])) * t)
    return float(f(rate) * f(lr))


def draw_noise(gen: torch.Generator, batch: int, n: int):
    """The uniforms of one training step, in the order the step draws them:
    the proposal edges' jitter [B, n + 1] in [0, 1), then the resample
    jitter [B, n + 1] in [0, 1/(n + 1) - eps)."""
    shape = (batch, n + 1)
    a = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    b = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return a, b * float(np.float32(1.0 / (n + 1)) - F32_EPS)


def train_steps(model: dict, train: dict, params0, batches, gen,
                matmul: str = "float32", drop_half: bool = False):
    """``len(batches)`` joint-cadence AdamW steps from ``params0`` (a tree
    of tensors, not changed), each batch a (rays dict, pixels) on the
    device, the noise drawn from ``gen``. Returns {"losses": [per step
    {name: float}], "grad1": {path: first step's gradient}, "params":
    {path: params after the last step}}. ``drop_half``: each step uses its
    batch's first half only (a fault, for the control runs)."""
    from ..weights import leaves

    tree = _map(lambda p: p.detach().clone().requires_grad_(), params0)
    named = leaves(tree)
    mu = [torch.zeros_like(p) for _, p in named]
    nu = [torch.zeros_like(p) for _, p in named]
    out = {"losses": [], "grad1": {}, "params": {}}
    for k, (rays, pixels) in enumerate(batches):
        noise = draw_noise(gen, pixels.shape[0], model["num_samples"])
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
            out["grad1"] = {n_: g.detach().clone() for (n_, _), g in zip(named, grads)}
        lr = learning_rate(train, k)
        c = k + 1
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(c))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(c))
        with torch.no_grad():
            for (_, p), g, m1, m2 in zip(named, grads, mu, nu):
                m1.mul_(B1).add_((1 - B1) * g)
                m2.mul_(B2).add_((1 - B2) * g * g)
                u = (m1 / bc1) / (torch.sqrt(m2 / bc2) + ADAM_EPS) + train["weight_decay"] * p
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


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def to_device(arrays: dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}

