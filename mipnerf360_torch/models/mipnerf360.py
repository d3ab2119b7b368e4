"""The Mip-NeRF 360 model: proposal MLP + NeRF MLP (counterpart of
``mipnerf360_tpu/models/mipnerf360.py``).

The functions take params as the JAX package's nested tree —
``{"prop": {"layers": [...]}, "nerf": {"trunk"|"density"|"rgb": {"layers":
[...]}}}`` of tensors — and :class:`MipNeRF360` is the ``nn.Module`` that holds
them with the same nesting. Where the JAX package threads a ``jax.random``
key, the randomized branches here take explicit noise tensors (or draw from a
``torch.Generator``). Both composites go through ``ops.fused``: a CUDA tensor
launches the Hopper kernel K1 (and K2 in the backward), a CPU tensor takes
its plain version; only the sample-axis render composites the NeRF level
across ranks, in plain PyTorch (``parallel/sample_axis.py``). The forward
functions run under autograd; only ``render_image`` runs under
``torch.inference_mode``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..core.encoding import integrated_pos_enc, viewdir_enc
from ..core.fused_encode import factored_ipe
from ..core.gaussians import cast_rays
from ..core.rays import Rays, rays_map, rays_to_device, resolve_device
from ..core.rendering import composite_outputs
from ..core.sampling import _uniform, sample_along_rays, stratified_jitter
from ..core.spacing import t_to_s
from ..ops import fused
from ..parallel.collectives import gather_cat
from ..parallel.mesh import make_mesh, rank_device
from ..parallel.sample_axis import make_sample_sharded_composite
from ..utils.trace import span
from .mlp import apply_mlp, init_mlp

Params = Dict[str, Any]


class RenderNoise(NamedTuple):
    """The uniform draws of a randomized forward: ``sample`` [B, N+1] in
    [0, 1) jitters the proposal edges, ``resample`` [B, N+1] in
    [0, 1/(N+1) - eps) is the stratified inverse-CDF jitter of the NeRF level
    (the draws the JAX package takes from its two split keys)."""

    sample: torch.Tensor
    resample: torch.Tensor


def draw_render_noise(generator: torch.Generator, batch: int,
                      num_samples: int, device) -> RenderNoise:
    """The uniforms a randomized :func:`render_rays` of ``batch`` rays draws
    from ``generator`` when it is given no noise, in the same order and bit
    for bit. A data-parallel step draws them over the global batch and keeps
    its own rows, so that every rank takes the one-process step's noise."""
    like = torch.empty(0, device=device)
    shape = (batch, num_samples + 1)
    sample = _uniform(shape, like, generator)
    return RenderNoise(sample, stratified_jitter(shape, like, generator))


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None
               ) -> Params:
    """Kaiming-uniform params drawn on the CPU from ``generator`` (seed 0
    when None), with the ``pad_input_lanes`` zero rows appended after the
    real-fan-in draw."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    d = cfg.input_dim
    prop_sizes = [d] + [cfg.hidden_proposal] * cfg.proposal_depth + [1]
    nerf_sizes = [d] + [cfg.hidden_nerf] * cfg.nerf_depth
    params = {
        "prop": init_mlp(generator, prop_sizes),
        "nerf": {
            "trunk": init_mlp(generator, nerf_sizes),
            "density": init_mlp(generator, [cfg.hidden_nerf, 1]),
            "rgb": init_mlp(generator, [cfg.hidden_nerf, 3]),
        },
    }
    pad = cfg.padded_input_dim - d
    if pad:
        for tower in (params["prop"], params["nerf"]["trunk"]):
            w = tower["layers"][0]["w"]
            tower["layers"][0]["w"] = torch.cat(
                [w, torch.zeros((pad, w.shape[1]), dtype=w.dtype)], dim=0)
    return params


def map_params(fn, params: Params) -> Params:
    """Apply ``fn`` to every array of a params tree, keeping its nesting."""
    if isinstance(params, dict):
        return {k: map_params(fn, v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [map_params(fn, v) for v in params]
    return fn(params)


def _prop_activations(cfg: ModelConfig):
    final = "sigmoid" if cfg.trunk_final_sigmoid else "relu"
    return ["relu"] * (cfg.proposal_depth - 1) + [final] + ["none"]


def _trunk_activations(cfg: ModelConfig):
    final = "sigmoid" if cfg.trunk_final_sigmoid else "relu"
    return ["relu"] * (cfg.nerf_depth - 1) + [final]


def _softplus(x):
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _encode(cfg: ModelConfig, rays: Rays, t_vals):
    """Cast intervals to contracted Gaussians and build MLP input features."""
    with span("model.encode"):
        if cfg.factored_encode:
            pos = factored_ipe(t_vals, rays.origins, rays.directions,
                               rays.radii, ray_shape=cfg.ray_shape,
                               min_deg=cfg.ipe_min_deg,
                               max_deg=cfg.ipe_max_deg)  # [B, N, 42*scales]
        else:
            means, covs = cast_rays(t_vals, rays.origins, rays.directions,
                                    rays.radii, ray_shape=cfg.ray_shape)
            pos = integrated_pos_enc(means, covs, cfg.ipe_min_deg,
                                     cfg.ipe_max_deg)    # [B, N, 42*scales]
        view = viewdir_enc(rays.viewdirs, cfg.viewdir_min_deg,
                           cfg.viewdir_max_deg)
        view = view[..., None, :].expand(pos.shape[:-1] + (view.shape[-1],))
        x = torch.cat([pos, view], dim=-1)
        pad = cfg.padded_input_dim - cfg.input_dim
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
        return x


def prop_forward(params: Params, cfg: ModelConfig, rays: Rays,
                 randomized: bool, *, noise=None, generator=None):
    """Proposal level: sample -> encode -> density -> weights."""
    with span("model.sample"):
        t_vals = sample_along_rays(rays.near, rays.far, cfg.num_samples,
                                   randomized, noise=noise, generator=generator)
    x = _encode(cfg, rays, t_vals)
    raw = apply_mlp(params["prop"], x, _prop_activations(cfg), _compute_dtype(cfg))
    with span("model.composite"):
        density = _softplus(raw[..., 0] + cfg.density_bias)
        weights = fused.compute_alpha_weights(
            density, t_vals, rays.directions, cfg.use_pallas)
    return t_vals, weights


def nerf_forward(params: Params, cfg: ModelConfig, rays: Rays, t_vals, weights,
                 randomized: bool, *, noise=None, generator=None,
                 composite_fn=None, tp_group=None):
    """NeRF level: resample -> encode -> trunk -> heads -> composite.

    With ``cfg.remat`` the tower (trunk and heads) runs under
    ``torch.utils.checkpoint``, the port's ``jax.checkpoint``: its
    activations are not kept for the backward but recomputed there.

    ``composite_fn`` (a ``parallel.sample_axis.SampleShardedComposite``)
    splits the samples over the mesh's model axis: this rank encodes and
    runs the tower on its own run of samples only, and the returned
    ``t_vals``, ``weights`` and ``s_vals`` are that run's. ``tp_group``:
    ``params["nerf"]["trunk"]`` is this rank's tensor-parallel shard over
    that group (``parallel.mesh.shard_params``).
    """
    with span("model.sample"):
        new_t = fused.resample_along_rays(t_vals, weights, randomized,
                                          cfg.resample_padding, cfg.use_pallas,
                                          u_typo=cfg.resample_u_typo,
                                          noise=noise, generator=generator)
    full_t = new_t
    if composite_fn is not None:
        sl = composite_fn.local_slice(new_t.shape[-1] - 1)
        new_t = new_t[..., sl.start:sl.stop + 1]
    x = _encode(cfg, rays, new_t)
    dt = _compute_dtype(cfg)

    def tower(nerf, x):
        feat = apply_mlp(nerf["trunk"], x, _trunk_activations(cfg), dt,
                         tp_group=tp_group)
        raw_density = apply_mlp(
            nerf["density"], feat,
            ["sigmoid" if cfg.density_head_sigmoid else "none"], dt)
        raw_rgb = apply_mlp(nerf["rgb"], feat, ["sigmoid"], dt)
        return raw_density, raw_rgb

    if cfg.remat and torch.is_grad_enabled():
        raw_density, raw_rgb = checkpoint(tower, params["nerf"], x,
                                          use_reentrant=False)
    else:
        raw_density, raw_rgb = tower(params["nerf"], x)

    with span("model.composite"):
        rgb = raw_rgb * (1.0 + 2.0 * cfg.rgb_padding) - cfg.rgb_padding
        density = _softplus(raw_density[..., 0] + cfg.density_bias)
        if composite_fn is not None:
            comp_rgb, distance, acc, w = composite_fn(rgb, density, full_t,
                                                      rays.directions)
        else:
            w = fused.compute_alpha_weights(
                density, new_t, rays.directions, cfg.use_pallas)
            comp_rgb, distance, acc = composite_outputs(rgb, w, new_t,
                                                        cfg.white_bkgd)
        s_vals = t_to_s(new_t, rays.near, rays.far)
    return {
        "rgb": comp_rgb,
        "distance": distance,
        "acc": acc,
        "t_vals": new_t,
        "weights": w,
        "s_vals": s_vals,
    }


def render_rays(params: Params, cfg: ModelConfig, rays: Rays, randomized: bool,
                *, noise: Optional[RenderNoise] = None,
                generator: Optional[torch.Generator] = None,
                composite_fn=None, tp_group=None):
    """Full two-level forward, returning both levels' internals.

    With ``randomized``, ``noise`` supplies both levels' uniform draws; when
    it is None they are drawn from ``generator``. ``composite_fn`` and
    ``tp_group`` apply to the NeRF level only (see :func:`nerf_forward`):
    the proposal level, whose weights feed the resampling, runs whole on
    every rank.
    """
    n_prop, n_nerf = (None, None) if noise is None else noise
    t_prop, w_prop = prop_forward(params, cfg, rays, randomized,
                                  noise=n_prop, generator=generator)
    out = nerf_forward(params, cfg, rays, t_prop, w_prop, randomized,
                       noise=n_nerf, generator=generator,
                       composite_fn=composite_fn, tp_group=tp_group)
    out["t_prop"] = t_prop
    out["w_prop"] = w_prop
    return out


def render_image(params: Params, cfg: ModelConfig, rays: Rays, *,
                 chunk: int = 8192, mesh=None, device="cuda"):
    """Render a flat [n_rays] batch deterministically, ``chunk`` rays at a time.

    ``rays`` (NumPy arrays or tensors) and ``params`` are moved to ``device``,
    which is the card unless the caller passes ``device="cpu"``; a missing
    card raises. Rays are padded with the last ray up to a multiple of
    ``chunk``, chunks are rendered in a host loop under
    ``torch.inference_mode()``, and the results stay on ``device``.
    Returns (rgb [n,3], distance [n], acc [n]).

    With ``mesh`` (a ``parallel.Mesh``; ``device`` is then the mesh's), the
    chunk is rounded up to a multiple of the data axis, each data rank
    renders its share of every chunk, and one gather per chunk gives every
    rank the whole result. A mesh with a model axis holds the
    tensor-parallel shards of the trunk (``parallel.mesh.shard_params``).
    With ``cfg.sample_shards > 1`` the NeRF level's samples are split over
    the model axis instead (``parallel/sample_axis.py``; params whole): on
    ``mesh`` when its model axis is ``sample_shards`` wide, else on the
    ``(world // sample_shards, sample_shards)`` mesh (on ``mesh``'s device,
    or on ``device`` without one), which needs a process group whose size
    ``sample_shards`` divides.
    """
    composite_fn = tp_group = None
    if cfg.sample_shards > 1:
        if mesh is None or mesh.model != cfg.sample_shards:
            mesh = make_mesh(-1, cfg.sample_shards,
                             device=(rank_device(device) if mesh is None
                                     else mesh.device))
        composite_fn = make_sample_sharded_composite(mesh, cfg.white_bkgd)
    elif mesh is not None:
        tp_group = mesh.model_group
    device = mesh.device if mesh is not None else resolve_device(device)
    with span("render.upload"):
        rays = rays_to_device(rays, device)
        params = map_params(lambda p: p.to(device), params)
    lo, per = 0, chunk
    if mesh is not None:
        chunk = -(-chunk // mesh.data) * mesh.data
        per = chunk // mesh.data
        lo = mesh.data_index * per
    n = rays.origins.shape[0]
    pad = (-n) % chunk
    if pad:
        rays = rays_map(
            lambda x: torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])], dim=0),
            rays)
    rgb, distance, acc = [], [], []
    with torch.inference_mode():
        for start in range(lo, n + pad, chunk):
            with span("render.chunk"):
                chunk_rays = rays_map(lambda x: x[start:start + per], rays)
                out = render_rays(params, cfg, chunk_rays, randomized=False,
                                  composite_fn=composite_fn, tp_group=tp_group)
                if mesh is not None:
                    packed = torch.cat([out["rgb"], out["distance"][:, None],
                                        out["acc"][:, None]], dim=-1)
                    packed = gather_cat(packed, mesh.data_group, dim=0)
                    out = {"rgb": packed[:, :3], "distance": packed[:, 3],
                           "acc": packed[:, 4]}
            rgb.append(out["rgb"])
            distance.append(out["distance"])
            acc.append(out["acc"])
    return (torch.cat(rgb)[:n], torch.cat(distance)[:n], torch.cat(acc)[:n])


class _Linear(nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.w = nn.Parameter(torch.as_tensor(layer["w"]))
        self.b = nn.Parameter(torch.as_tensor(layer["b"]))


class _MLP(nn.Module):
    def __init__(self, mlp):
        super().__init__()
        self.layers = nn.ModuleList(_Linear(layer) for layer in mlp["layers"])

    def tree(self):
        return {"layers": [{"w": l.w, "b": l.b} for l in self.layers]}


class MipNeRF360(nn.Module):
    """The model's params as an ``nn.Module``, nested as the JAX tree
    (state-dict keys ``prop.layers.0.w``, ``nerf.trunk.layers.3.b``, ...).

    ``params`` (a tree as :func:`init_model` or ``interop.params_from_jax``
    returns) defaults to :func:`init_model` with ``generator``.
    """

    def __init__(self, cfg: ModelConfig, params: Optional[Params] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_model(cfg, generator)
        self.prop = _MLP(params["prop"])
        self.nerf = nn.ModuleDict(
            {k: _MLP(params["nerf"][k]) for k in ("trunk", "density", "rgb")})

    def params(self) -> Params:
        """The parameters as the nested tree the functions take; its leaves
        are this module's ``nn.Parameter``s, so a loss built from it reaches
        them."""
        return {"prop": self.prop.tree(),
                "nerf": {k: m.tree() for k, m in self.nerf.items()}}

    def forward(self, rays: Rays, randomized: bool = False, *,
                noise: Optional[RenderNoise] = None,
                generator: Optional[torch.Generator] = None):
        return render_rays(self.params(), self.cfg, rays, randomized,
                           noise=noise, generator=generator)

    def render_image(self, rays: Rays, *, chunk: int = 8192, mesh=None,
                     device="cuda"):
        """:func:`render_image` with this module's params."""
        return render_image(self.params(), self.cfg, rays, chunk=chunk,
                            mesh=mesh, device=device)
