"""The Mip-NeRF 360 model: proposal MLP + NeRF MLP (counterpart of
``mipnerf360_tpu/models/mipnerf360.py``).

The functions take params as the JAX package's nested tree —
``{"prop": {"layers": [...]}, "nerf": {"trunk"|"density"|"rgb": {"layers":
[...]}}}`` of tensors — and :class:`MipNeRF360` is the ``nn.Module`` that holds
them with the same nesting. The published layout (``ModelConfig``'s
``proposal_rounds``, ``trunk_skip``, ``bottleneck_width``, ...; the
``garden_paper`` preset) adds ``nerf.bottleneck``, widens the trunk's skip
layers by the input, and makes ``nerf.rgb`` the view branch: its first layer
takes the bottleneck and the view-direction encoding. Where the JAX package
threads a ``jax.random`` key, the randomized branches here take explicit
noise tensors (or draw from a ``torch.Generator``). Both composites go through ``ops.fused``: a CUDA tensor
launches the Hopper kernel K1 (and K2 in the backward), a CPU tensor takes
its plain version; only the sample-axis render composites the NeRF level
across ranks, in plain PyTorch (``parallel/sample_axis.py``). The factored
encode goes through ``ops.encode``: on a CUDA tensor the kernel ENC writes
the first MLP layer's input in the compute dtype (VIEW the view branch's
direction features), on a CPU tensor the plain float32 composition. The
MLPs, the NeRF level's one tower with its layout as data, go through
``models/mlp.py``, which alone chooses the card's fused stack or the chain.
Zip-NeRF's grid layout (``encoding="hashgrid"``, the ``garden_zip`` preset)
gives each proposal round its own subtree, ``params["prop"][i]``, and each
sampling level a float32 table under ``"grid"`` (``nerf.grid`` for the NeRF
level); its encode goes through ``ops.hashgrid`` (the kernels H1 and, in the
backward, H2 on a CUDA tensor; the plain composition on a CPU one), its
multisample pattern turned by the forward's noise (``RenderNoise.pattern``)
or, in ``render_image``, by a fixed rule.
The forward functions run under autograd; only ``render_image`` runs under
``torch.inference_mode``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..core.encoding import integrated_pos_enc
from ..core.gaussians import cast_rays
from ..core.hashgrid import model_grid_spec
from ..core.rays import Rays, rays_map, rays_to_device, resolve_device
from ..core.rendering import composite_outputs
from ..core.sampling import _uniform, sample_along_rays, stratified_jitter
from ..core.spacing import t_to_s
from ..ops import encode, fused, hashgrid
from ..parallel.collectives import gather_cat
from ..parallel.mesh import make_mesh, rank_device
from ..parallel.sample_axis import make_sample_sharded_composite
from ..utils.trace import span
from .mlp import (ACTIVATIONS, Extra, apply_mlp, apply_tower, init_linear,
                  init_mlp)

Params = Dict[str, Any]


class RenderNoise(NamedTuple):
    """The uniform draws of a randomized forward: ``sample`` [B, N+1] in
    [0, 1) jitters the proposal edges, ``resample`` [B, N+1] in
    [0, 1/(N+1) - eps) is the stratified inverse-CDF jitter of the NeRF level
    (the draws the JAX package takes from its two split keys). With more
    than one proposal round, ``resample`` holds each resampling's jitter in
    turn along its last axis: [B, N+1] for each round after the first, then
    the NeRF level's [B, nerf_samples + 1]. On the grid layout ``pattern``
    [B, 2 M] in [0, 1) turns and mirrors the multisample patterns (M the
    intervals of all sampling levels, :func:`pattern_intervals`): for each
    level in order, its [B, N] turns, then its [B, N] mirrors; None
    elsewhere."""

    sample: torch.Tensor
    resample: torch.Tensor
    pattern: Optional[torch.Tensor] = None


def draw_render_noise(generator: torch.Generator, batch: int,
                      num_samples: int, device, rounds: int = 1,
                      nerf_samples: int = 0, pattern: int = 0
                      ) -> RenderNoise:
    """The uniforms a randomized :func:`render_rays` of ``batch`` rays draws
    from ``generator`` when it is given no noise, in the same order and bit
    for bit (``rounds`` proposal rounds, ``nerf_samples`` NeRF samples, 0:
    ``num_samples``; ``pattern``: the grid layout's intervals a ray,
    :func:`pattern_intervals`, whose turns and mirrors come last). A
    data-parallel step draws them over the global batch and keeps its own
    rows, so that every rank takes the one-process step's noise."""
    like = torch.empty(0, device=device)
    shape = (batch, num_samples + 1)
    sample = _uniform(shape, like, generator)
    jitters = [stratified_jitter(shape, like, generator)
               for _ in range(rounds - 1)]
    jitters.append(stratified_jitter(
        (batch, (nerf_samples or num_samples) + 1), like, generator))
    turns = (_uniform((batch, 2 * pattern), like, generator) if pattern
             else None)
    return RenderNoise(sample, torch.cat(jitters, dim=-1) if rounds > 1
                       else jitters[0], turns)


def pattern_intervals(cfg: ModelConfig) -> int:
    """Intervals a ray over every sampling level on the grid layout (each
    takes a turn and a mirror uniform), else 0."""
    if cfg.encoding != "hashgrid":
        return 0
    return cfg.proposal_rounds * cfg.num_samples + cfg.nerf_sample_count


def _pattern(cfg: ModelConfig, noise: Optional[RenderNoise], level: int):
    """(turn, mirror) [B, N] of sampling level ``level`` of ``noise``, or
    None (the render's pattern)."""
    if noise is None or len(noise) < 3 or noise[2] is None:
        return None
    n = [cfg.num_samples] * cfg.proposal_rounds + [cfg.nerf_sample_count]
    lo = 2 * sum(n[:level])
    p = noise[2]
    return (p[..., lo:lo + n[level]], p[..., lo + n[level]:lo + 2 * n[level]])


def _noise_parts(cfg: ModelConfig, noise: Optional[RenderNoise]):
    """(the first round's edge jitter, each later round's resample jitter,
    the NeRF level's) of ``noise``, all None without it."""
    if noise is None:
        return None, [None] * (cfg.proposal_rounds - 1), None
    n = cfg.num_samples + 1
    sample, r = noise[0], noise[1]
    return (sample, [r[..., i * n:(i + 1) * n]
                     for i in range(cfg.proposal_rounds - 1)],
            r[..., (cfg.proposal_rounds - 1) * n:])


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# Instant-NGP's table init: U(-GRID_INIT, GRID_INIT).
GRID_INIT = 1e-4


def _init_grid(generator: torch.Generator, cfg: ModelConfig, level: int):
    spec = model_grid_spec(cfg, level)
    u = torch.rand((spec.entries, spec.features), generator=generator,
                   dtype=torch.float32)
    return u * (2.0 * GRID_INIT) - GRID_INIT


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None
               ) -> Params:
    """Kaiming-uniform params drawn on the CPU from ``generator`` (seed 0
    when None), with the ``pad_input_lanes`` zero rows appended after the
    real-fan-in draw. On the grid layout ``params["prop"]`` holds one
    subtree a round, each with its table under ``"grid"`` drawn after its
    MLP, and the NeRF level's table is drawn after all of its layers."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    grid = cfg.encoding == "hashgrid"
    d, hn = cfg.input_dim, cfg.hidden_nerf
    hidden = [cfg.hidden_proposal] * cfg.proposal_depth + [1]
    trunk_in = [d] + [hn + d if i in cfg.skip_layers else hn
                      for i in range(1, cfg.nerf_depth)]
    if grid:
        prop = [dict(init_mlp(generator, [cfg.grid_dim(r)] + hidden),
                     grid=_init_grid(generator, cfg, r))
                for r in range(cfg.proposal_rounds)]
    else:
        prop = init_mlp(generator, [d] + hidden)
    nerf = {"trunk": {"layers": [init_linear(generator, fi, hn)
                                 for fi in trunk_in]}}
    if not cfg.bottleneck_density:
        nerf["density"] = init_mlp(generator, [hn, 1])
    if cfg.bottleneck_width:
        nerf["bottleneck"] = init_mlp(generator, [hn, cfg.bottleneck_width])
        nerf["rgb"] = init_mlp(generator, [
            cfg.bottleneck_width + cfg.viewdir_dim]
            + [cfg.viewdir_width] * cfg.viewdir_depth + [3])
    else:
        nerf["rgb"] = init_mlp(generator, [hn, 3])
    if grid:
        nerf["grid"] = _init_grid(generator, cfg, cfg.proposal_rounds)
    params = {"prop": prop, "nerf": nerf}
    pad = cfg.padded_input_dim - d
    if pad:
        trunk = params["nerf"]["trunk"]["layers"]
        for layer in [params["prop"]["layers"][0], trunk[0]] + [
                trunk[i] for i in cfg.skip_layers]:
            w = layer["w"]
            layer["w"] = torch.cat(
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


_softplus = ACTIVATIONS["softplus"]  # jax.nn.softplus: logaddexp(x, 0)


def _encode(cfg: ModelConfig, rays: Rays, t_vals, level: int = 0,
            table=None, pattern=None):
    """Cast intervals to contracted Gaussians and build MLP input features:
    on the grid layout, sampling level ``level``'s multisampled grid encode
    through ``ops.hashgrid`` (H1 on the card, in the compute dtype) from
    ``table`` with the multisample ``pattern`` (None: the render's); else
    the factored encode through ``ops.encode`` (ENC on the card, in the
    compute dtype), else the general path in float32."""
    view_degs = (None if cfg.bottleneck_width
                 else (cfg.viewdir_min_deg, cfg.viewdir_max_deg))
    with span("model.encode"):
        if cfg.encoding == "hashgrid":
            return hashgrid.encode_grid(table, t_vals, rays,
                                        model_grid_spec(cfg, level), pattern,
                                        _compute_dtype(cfg))
        if cfg.factored_encode:
            return encode.encode_points(
                t_vals, rays, ray_shape=cfg.ray_shape,
                min_deg=cfg.ipe_min_deg, max_deg=cfg.ipe_max_deg,
                view_degs=view_degs, width=cfg.padded_input_dim,
                dtype=_compute_dtype(cfg))
        means, covs = cast_rays(t_vals, rays.origins, rays.directions,
                                rays.radii, ray_shape=cfg.ray_shape)
        pos = integrated_pos_enc(means, covs, cfg.ipe_min_deg,
                                 cfg.ipe_max_deg)    # [B, N, 42*scales]
        return encode.features(pos, rays.viewdirs, view_degs,
                               cfg.padded_input_dim)


def prop_forward(params: Params, cfg: ModelConfig, rays: Rays,
                 randomized: bool, *, noise=None, generator=None,
                 pattern=None):
    """Proposal level (its first round): sample -> encode -> density ->
    weights. ``pattern``: the grid layout's multisample pattern of the
    round (see :func:`_encode`)."""
    with span("model.sample"):
        t_vals = sample_along_rays(rays.near, rays.far, cfg.num_samples,
                                   randomized, noise=noise, generator=generator)
    return t_vals, _prop_weights(params, cfg, rays, t_vals, 0, pattern)


def _prop_params(params: Params, cfg: ModelConfig, r: int):
    """Proposal round ``r``'s subtree."""
    return params["prop"][r] if cfg.distinct_proposals else params["prop"]


def _prop_weights(params: Params, cfg: ModelConfig, rays: Rays, t_vals,
                  r: int = 0, pattern=None):
    prop = _prop_params(params, cfg, r)
    x = _encode(cfg, rays, t_vals, r, prop.get("grid"), pattern)
    raw = apply_mlp(prop, x, _prop_activations(cfg), _compute_dtype(cfg))
    with span("model.composite"):
        density = _softplus(raw[..., 0] + cfg.density_bias)
        return fused.compute_alpha_weights(
            density, t_vals, rays.directions, cfg.use_pallas)


def prop_rounds(params: Params, cfg: ModelConfig, rays: Rays,
                randomized: bool, *, noise: Optional[RenderNoise] = None,
                generator=None):
    """Every proposal round through the proposal MLP (its own with
    ``distinct_proposals``): [(t_vals, weights)] in order, each round after
    the first resampling ``num_samples`` samples from the one before.
    ``noise``: the forward's :class:`RenderNoise` (its NeRF part unused)."""
    first, jitters, _ = _noise_parts(cfg, noise)
    rounds = [prop_forward(params, cfg, rays, randomized, noise=first,
                           generator=generator,
                           pattern=_pattern(cfg, noise, 0))]
    for r, jitter in enumerate(jitters, start=1):
        t, w = rounds[-1]
        with span("model.sample"):
            t = fused.resample_along_rays(t, w, randomized,
                                          cfg.resample_padding, cfg.use_pallas,
                                          u_typo=cfg.resample_u_typo,
                                          noise=jitter, generator=generator)
        rounds.append((t, _prop_weights(params, cfg, rays, t, r,
                                        _pattern(cfg, noise, r))))
    return rounds


def nerf_forward(params: Params, cfg: ModelConfig, rays: Rays, t_vals, weights,
                 randomized: bool, *, noise=None, generator=None,
                 composite_fn=None, tp_group=None, pattern=None):
    """NeRF level: resample -> encode -> trunk -> heads -> composite.

    With ``cfg.remat`` the tower (trunk, heads, view branch) runs under
    ``torch.utils.checkpoint``, the port's ``jax.checkpoint``: its
    activations are not kept for the backward but recomputed there.

    ``composite_fn`` (a ``parallel.sample_axis.SampleShardedComposite``)
    splits the samples over the mesh's model axis: this rank encodes and
    runs the tower on its own run of samples only, and the returned
    ``t_vals``, ``weights`` and ``s_vals`` are that run's. ``tp_group``:
    ``params["nerf"]["trunk"]`` is this rank's tensor-parallel shard over
    that group (``parallel.mesh.shard_params``). ``pattern``: the grid
    layout's multisample pattern of the level (see :func:`_encode`).
    """
    with span("model.sample"):
        new_t = fused.resample_along_rays(t_vals, weights, randomized,
                                          cfg.resample_padding, cfg.use_pallas,
                                          u_typo=cfg.resample_u_typo,
                                          noise=noise, generator=generator,
                                          num_edges=cfg.nerf_sample_count + 1)
    full_t = new_t
    if composite_fn is not None:
        sl = composite_fn.local_slice(new_t.shape[-1] - 1)
        new_t = new_t[..., sl.start:sl.stop + 1]
    x = _encode(cfg, rays, new_t, cfg.proposal_rounds,
                params["nerf"].get("grid"), pattern)
    dt = _compute_dtype(cfg)

    def tower(nerf, x, view):
        """The trunk under the density and rgb heads, or under the density
        head and the bottleneck, or under the bottleneck alone whose channel
        0 is the density, with the view branch (``view``) on it."""
        if cfg.bottleneck_density:
            (y,) = apply_tower(nerf["trunk"], nerf["bottleneck"]["layers"],
                               x, _trunk_activations(cfg), dt, tp_group)
            y_density = y[..., :1]
        else:
            branch = "rgb" if view is None else "bottleneck"
            y_density, y = apply_tower(
                nerf["trunk"],
                [nerf[k]["layers"][0] for k in ("density", branch)],
                x, _trunk_activations(cfg), dt, tp_group,
                extras=[Extra(i) for i in cfg.skip_layers],
                rounded_head=view is not None)
        with span("model.mlp"):
            raw_density = ACTIVATIONS[
                "sigmoid" if cfg.density_head_sigmoid else "none"](y_density)
            if view is None:
                return raw_density, torch.sigmoid(y)
            view = view.to(dt)[..., None, :].expand(
                x.shape[:-1] + view.shape[-1:])
            return raw_density, apply_mlp(
                nerf["rgb"], y, ["relu"] * cfg.viewdir_depth + ["sigmoid"],
                dt, extras=[Extra(0, view)])

    view = None
    if cfg.bottleneck_width:
        if composite_fn is not None or tp_group is not None:
            raise ValueError("the view-branch layout (bottleneck_width > 0) "
                             "has no tensor-parallel or sample-axis path")
        with span("model.encode"):
            view = encode.encode_viewdirs(rays.viewdirs, cfg.viewdir_min_deg,
                                          cfg.viewdir_max_deg, dt)
    if cfg.remat and torch.is_grad_enabled():
        tower = functools.partial(checkpoint, tower, use_reentrant=False)
    raw_density, raw_rgb = tower(params["nerf"], x, view)

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
    """Full forward, returning every level's internals: the NeRF level's,
    ``props`` (each proposal round's (t_vals, weights)), and ``t_prop``,
    ``w_prop`` (the first round's).

    With ``randomized``, ``noise`` supplies every level's uniform draws; when
    it is None they are drawn from ``generator`` (on the grid layout all at
    once, as :func:`draw_render_noise` draws them). ``composite_fn`` and
    ``tp_group`` apply to the NeRF level only (see :func:`nerf_forward`):
    the proposal level, whose weights feed the resampling, runs whole on
    every rank.
    """
    if randomized and noise is None and pattern_intervals(cfg):
        noise = draw_render_noise(
            generator, rays.origins.shape[0], cfg.num_samples,
            rays.origins.device, cfg.proposal_rounds, cfg.nerf_samples,
            pattern_intervals(cfg))
    props = prop_rounds(params, cfg, rays, randomized, noise=noise,
                        generator=generator)
    out = nerf_forward(params, cfg, rays, *props[-1], randomized,
                       noise=_noise_parts(cfg, noise)[2], generator=generator,
                       composite_fn=composite_fn, tp_group=tp_group,
                       pattern=_pattern(cfg, noise, cfg.proposal_rounds))
    out["t_prop"], out["w_prop"] = props[0]
    out["props"] = props
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
        if "grid" in mlp:
            self.grid = nn.Parameter(torch.as_tensor(mlp["grid"]))

    def tree(self):
        out = {"layers": [{"w": l.w, "b": l.b} for l in self.layers]}
        if hasattr(self, "grid"):
            out["grid"] = self.grid
        return out


class MipNeRF360(nn.Module):
    """The model's params as an ``nn.Module``, nested as the JAX tree
    (state-dict keys ``prop.layers.0.w``, ``nerf.trunk.layers.3.b``, ...;
    ``prop.0.layers.0.w``, ``prop.0.grid`` and ``nerf_grid`` on the grid
    layout).

    ``params`` (a tree as :func:`init_model` or ``interop.params_from_jax``
    returns) defaults to :func:`init_model` with ``generator``.
    """

    def __init__(self, cfg: ModelConfig, params: Optional[Params] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_model(cfg, generator)
        self.prop = (nn.ModuleList(_MLP(p) for p in params["prop"])
                     if cfg.distinct_proposals else _MLP(params["prop"]))
        self.nerf = nn.ModuleDict(
            {k: _MLP(params["nerf"][k])
             for k in ("trunk", "density", "bottleneck", "rgb")
             if k in params["nerf"]})
        if "grid" in params["nerf"]:
            self.nerf_grid = nn.Parameter(torch.as_tensor(
                params["nerf"]["grid"]))

    def params(self) -> Params:
        """The parameters as the nested tree the functions take; its leaves
        are this module's ``nn.Parameter``s, so a loss built from it reaches
        them."""
        nerf = {k: m.tree() for k, m in self.nerf.items()}
        if hasattr(self, "nerf_grid"):
            nerf["grid"] = self.nerf_grid
        prop = ([m.tree() for m in self.prop] if self.cfg.distinct_proposals
                else self.prop.tree())
        return {"prop": prop, "nerf": nerf}

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
