"""The published Mip-NeRF 360 network on the port (``garden_paper``): two
proposal rounds, the trunk's skip, the bottleneck and the view branch.

On the CPU, at a small size of the same topology:

- the layout's config fields, their checks, and a default layout's
  ``config.json`` unchanged;
- the port against the plain float32 reference of the benchmark
  (``nerfbench/reference/paper_model.py``) on seeded weights: every level's
  forward, the losses, every parameter's gradient of one joint step, and
  ``render_image`` against the reference's ``render``;
- the plain E1 with a second input and the plain E3 with a wide head's dX
  against the chain they replace, and the fused stacks of the layout (the
  trunk with its skip under the density head and the bottleneck; the view
  branch with its direction encoding once a ray) against that chain, bit
  for bit (bias gradients to summation order), and so ``nerf_forward``'s
  fused wiring in this layout and the repo's;
- the spans the layout opens, the step's noise, the benchmark's weights,
  counts and cell at a tiny size.

On the card (marker ``cuda``, skipped here): the kernels with the new
operands against their plain versions, the fused tower against the chain
(bit for bit with G1's plain version in its place, and through G1 to its
summation order), and a step's launches (16 G1, 1 E1).
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mipnerf360_torch.config import Config, ModelConfig, TrainConfig, get_config
from mipnerf360_torch.core.rays import Rays, dummy_rays, rays_to_device
from mipnerf360_torch.models import mipnerf360 as tm
from mipnerf360_torch.models import mlp as tmlp
from mipnerf360_torch.ops import mlp_epilogue as epi
from mipnerf360_torch.ops import mlp_gemm
from mipnerf360_torch.train.state import make_train_state
from mipnerf360_torch.train.step import (joint_cadence_grads, make_train_step,
                                         reference_cadence_step)
from mipnerf360_torch.utils import trace
from nerfbench import paper, weights
from nerfbench.reference import model as ref
from nerfbench.reference import paper_model as pref

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
PAPER = get_config("garden_paper").model
LAYOUT = ("proposal_rounds", "nerf_samples", "trunk_skip", "bottleneck_width",
          "viewdir_width")


def small_model(**kw) -> ModelConfig:
    """The published topology at a small size: two rounds of 8 proposal
    samples, 4 NeRF samples, a trunk of 4 layers of 32 with the skip after
    the third, a bottleneck of 8, a view layer of 16, 2 IPE scales."""
    return dataclasses.replace(
        PAPER, num_samples=8, nerf_samples=4, hidden_proposal=16,
        proposal_depth=2, hidden_nerf=32, nerf_depth=4, trunk_skip=2,
        bottleneck_width=8, viewdir_width=16, ipe_max_deg=2,
        compute_dtype="float32", **kw)


def _model_dict(m: ModelConfig) -> dict:
    return dataclasses.asdict(m)


def _train_dict() -> dict:
    t = get_config("garden_paper").train
    return dict(dataclasses.asdict(t), lr_max_steps=10000)


def _rays(n, seed):
    return rays_to_device(dummy_rays(n, seed=seed), "cpu")


def _ref_rays(r: Rays) -> dict:
    return {k: getattr(r, k) for k in r._fields}


# --------------------------------------------------------------- config


def test_garden_paper_is_the_published_layout():
    cfg = get_config("garden_paper")
    m = cfg.model
    assert (m.proposal_rounds, m.num_samples, m.nerf_sample_count) == (2, 64, 32)
    assert (m.input_dim, m.viewdir_dim, m.skip_layers) == (504, 27, (5,))
    assert (m.hidden_proposal, m.proposal_depth, m.hidden_nerf,
            m.nerf_depth) == (256, 4, 1024, 8)
    assert (m.bottleneck_width, m.viewdir_width, m.ray_shape) == (256, 128,
                                                                  "cone")
    assert cfg.train.batch_size == 2**14
    quality = get_config("garden_quality")
    for group in ("train", "data"):
        a = dataclasses.asdict(getattr(cfg, group))
        b = dataclasses.asdict(getattr(quality, group))
        assert {k for k in a if a[k] != b[k]} <= {"batch_size"}
    a, b = dataclasses.asdict(m), dataclasses.asdict(quality.model)
    assert {k for k in a if a[k] != b[k]} == set(LAYOUT) | {"ipe_max_deg",
                                                            "ray_shape"}


@pytest.mark.parametrize("preset", ["garden_quality", "tiny_lego",
                                    "synthetic_quality", "garden_paper"])
def test_config_json_writes_the_layout_only_where_set(preset):
    cfg = get_config(preset)
    text = cfg.to_json()
    assert Config.from_json(text) == cfg
    written = set(json.loads(text)["model"])
    if preset == "garden_paper":
        assert set(LAYOUT) <= written
    else:
        assert not set(LAYOUT) & written


@pytest.mark.parametrize("bad", [
    dict(bottleneck_width=256),
    dict(viewdir_width=128),
    dict(proposal_rounds=0),
    dict(nerf_samples=-1),
    dict(trunk_skip=7),
    dict(trunk_skip=1)])
def test_layout_fields_refuse_what_has_no_meaning(bad):
    with pytest.raises(ValueError):
        ModelConfig(**bad)


def test_defaults_keep_the_repo_layout():
    m = ModelConfig()
    assert (m.proposal_rounds, m.nerf_sample_count, m.skip_layers,
            m.viewdir_dim) == (1, m.num_samples, (), 0)
    assert m.input_dim == 42 + 16
    params = tm.init_model(m)
    assert set(params["nerf"]) == {"trunk", "density", "rgb"}


def test_init_model_matches_the_benchmarks_shapes():
    m = small_model()
    mine = weights.leaves(tm.init_model(m))
    theirs = weights.leaves(paper.make_params(_model_dict(m), 3, "cpu"))
    assert [(k, tuple(v.shape)) for k, v in mine] == [
        (k, tuple(v.shape)) for k, v in theirs]
    full = dict(weights.leaves(paper.make_params(_model_dict(PAPER), 1,
                                                 "cpu")))
    assert tuple(full["nerf.trunk.layers.5.w"].shape) == (1528, 1024)
    assert tuple(full["nerf.rgb.layers.0.w"].shape) == (283, 128)
    assert tuple(full["nerf.bottleneck.layers.0.w"].shape) == (1024, 256)


def test_padded_input_pads_the_skip_rows():
    m = dataclasses.replace(small_model(), pad_input_lanes=True)
    params = tm.init_model(m)
    trunk = params["nerf"]["trunk"]["layers"]
    assert trunk[0]["w"].shape[0] == m.padded_input_dim == 128
    assert trunk[3]["w"].shape[0] == 32 + 128
    assert torch.all(trunk[3]["w"][32 + m.input_dim:] == 0)


# ------------------------------------------- the port against the reference


@pytest.fixture(scope="module")
def case():
    m = small_model()
    model = _model_dict(m)
    params = paper.make_params(model, 2**31 + 11, "cpu")
    rays = _ref_rays(_rays(48, 5))
    noise = pref.draw_noise(torch.Generator().manual_seed(4), 48, model)
    return m, model, params, rays, noise


def _close(a, b):
    torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("randomized", [True, False])
def test_forward_of_every_level_matches_the_reference(case, randomized):
    m, model, params, rays, noise = case
    noise = noise if randomized else None
    with torch.no_grad():
        got = tm.render_rays(params, m, Rays(**rays), randomized,
                             noise=None if noise is None
                             else tm.RenderNoise(*noise))
        want = pref.forward(model, params, rays, noise)
    assert len(got["props"]) == len(want["props"]) == 2
    for (t, w), (rt, rw) in zip(got["props"], want["props"]):
        assert t.shape == (48, 9)
        _close(t, rt)
        _close(w, rw)
    assert got["t_vals"].shape == (48, 5)
    for a, b in (("t_vals", "t"), ("weights", "w"), ("rgb", "rgb"),
                 ("acc", "acc"), ("distance", "distance")):
        _close(got[a], want[b])


def _port_step(m, params, rays, pixels, noise):
    cfg = Config(model=m, train=get_config("garden_paper").train)
    state = make_train_state(params, device="cpu",
                             generator=torch.Generator())
    return joint_cadence_grads(cfg, state, Rays(**rays), pixels,
                               noise=tm.RenderNoise(*noise))


def test_losses_and_gradients_of_a_joint_step_match_the_reference(case):
    m, model, params, rays, noise = case
    pixels = torch.rand(48, 3, generator=torch.Generator().manual_seed(6))
    grads, aux = _port_step(m, params, rays, pixels, noise)
    tree = ref._map(lambda p: p.detach().clone().requires_grad_(), params)
    named = weights.leaves(tree)
    fwd = pref.forward(model, tree, rays, noise)
    want = pref.losses(_train_dict(), fwd, pixels, rays["near"], rays["far"])
    for k in ("loss", "loss_nerf", "loss_dist", "loss_prop", "psnr"):
        torch.testing.assert_close(aux[k], want[k].detach(), rtol=1e-4,
                                   atol=1e-6)
    ref_grads = torch.autograd.grad(want["loss"], [p for _, p in named])
    mine = {f"{k}.{name}": g for k in ("prop", "nerf")
            for (name, _), g in zip(weights.leaves(params[k]), grads[k])}
    assert set(mine) == {name for name, _ in named}
    for (name, _), g in zip(named, ref_grads):
        scale = float(g.abs().max()) + 1e-12
        torch.testing.assert_close(mine[name] / scale, g / scale, rtol=0,
                                   atol=2e-4, msg=name)


def test_both_rounds_feed_the_distillation_loss(case):
    """The loss of the proposal MLP is the sum over both rounds: the
    reference's first-round hinge alone falls short of it."""
    m, model, params, rays, noise = case
    pixels = torch.rand(48, 3, generator=torch.Generator().manual_seed(6))
    _, aux = _port_step(m, params, rays, pixels, noise)
    fwd = pref.forward(model, params, rays, noise)
    (t1, w1), (t2, w2) = fwd["props"]
    one = ref.losses(_train_dict(), dict(fwd, t_prop=t1, w_prop=w1), pixels,
                     rays["near"], rays["far"])["loss_prop"]
    two = pref._hinge(fwd["t"], fwd["w"], t2, w2) / 48
    assert float(two) > 0
    torch.testing.assert_close(aux["loss_prop"], (one + two).detach(),
                               rtol=1e-4, atol=1e-7)


def test_render_image_matches_the_reference_render(case):
    m, model, params, _, _ = case
    rays = _ref_rays(_rays(70, 8))
    rgb, dist, acc = tm.render_image(params, m, Rays(**rays), chunk=32,
                                     device="cpu")
    want = pref.render(model, params, rays, block=16)
    _close(rgb, want["rgb"])
    _close(dist, want["distance"])
    _close(acc, want["acc"])


def test_step_noise_is_the_references_draw():
    """A randomized step without noise draws, from its generator, the
    reference's uniforms in order: the first round's edges, the second
    round's jitter, the NeRF level's."""
    model = _model_dict(small_model())
    a = tm.draw_render_noise(torch.Generator().manual_seed(9), 32, 8, "cpu",
                             rounds=2, nerf_samples=4)
    b = pref.draw_noise(torch.Generator().manual_seed(9), 32, model)
    assert a.resample.shape == (32, 9 + 5)
    assert torch.equal(a.sample, b[0]) and torch.equal(a.resample, b[1])


def test_a_step_without_noise_draws_what_draw_render_noise_draws(case):
    m, model, params, rays, _ = case
    pixels = torch.rand(48, 3)
    cfg = Config(model=m, train=TrainConfig(batch_size=48))
    drawn = tm.draw_render_noise(torch.Generator().manual_seed(3), 48, 8,
                                 "cpu", rounds=2, nerf_samples=4)

    def grads(noise):
        state = make_train_state(params, device="cpu",
                                 generator=torch.Generator().manual_seed(3))
        return joint_cadence_grads(cfg, state, Rays(**rays), pixels,
                                   noise=noise)

    (g0, a0), (g1, a1) = grads(None), grads(drawn)
    assert torch.equal(a0["loss"], a1["loss"])
    assert all(torch.equal(x, y) for x, y in zip(g0["nerf"], g1["nerf"]))


def test_reference_cadence_and_a_trained_step_run_the_layout(case):
    """The 2+1 cadence sums the distillation over both rounds too; a few
    joint steps change every parameter."""
    m, model, params, rays, noise = case
    pixels = torch.rand(48, 3)
    cfg = Config(model=m, train=TrainConfig(batch_size=48, cadence="reference",
                                            lr_delay_steps=0))
    state = make_train_state(params, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    state, aux = reference_cadence_step(cfg, state, Rays(**rays), pixels)
    assert state.sched_count == 3 and torch.isfinite(aux["loss_prop"])
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, cadence="joint"))
    state = make_train_state(params, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    step = make_train_step(cfg)
    for _ in range(2):
        state, aux = step(state, Rays(**rays), pixels)
    for (k, a), (_, b) in zip(weights.leaves(state.params),
                              weights.leaves(params)):
        assert not torch.equal(a.detach(), b), k


def test_the_layout_has_no_tensor_parallel_or_sample_axis_path(case):
    m, _, params, rays, _ = case
    with torch.no_grad(), pytest.raises(ValueError, match="view-branch"):
        tm.render_rays(params, m, Rays(**rays), False, tp_group=object())


def test_the_layout_opens_only_the_benchmarks_spans(case, monkeypatch):
    from nerfbench import spans as sp

    m, _, params, rays, noise = case
    names = []

    class Recorder:
        def __init__(self, name):
            names.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trace, "_range", Recorder)
    cfg = Config(model=m, train=TrainConfig(batch_size=48, lr_delay_steps=0))
    state = make_train_state(params, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]):
        make_train_step(cfg)(state, Rays(**rays), torch.rand(48, 3))
        tm.render_image(state.params, m, Rays(**rays), chunk=16, device="cpu")
    assert set(names) <= set(sp.SPANS)
    assert {"model.sample", "model.encode", "model.mlp", "model.composite",
            "step.losses", "step.adamw"} <= set(names)


def test_bench_tool_refuses_the_layout():
    from mipnerf360_torch.tools import bench

    with pytest.raises(ValueError, match="published"):
        bench.matmul_flops_per_ray(PAPER)


# ------------------------------------------------ kernels' plain versions


def _normal(shape, seed, scale=1.0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        scale=scale, size=shape).astype(np.float32))


@pytest.mark.parametrize("m", [1, 37, 148])
def test_plain_e1_with_a_second_input_is_the_chain_bit_for_bit(m):
    """relu(bf16((y + y1) + b)): the two products added in f32 before the
    bias, as the chain's ``_linear_extra`` adds them."""
    n = 24
    y, b = _normal((m, n), 1, 2.0), _normal(n, 2)
    y1 = _normal((m, n), 3, 2.0)
    got = epi.plain_bias_relu(y, b, y1)
    assert torch.equal(got, torch.relu(((y + y1) + b).to(BF16)))
    assert not torch.equal(got, epi.plain_bias_relu(y, b))


def test_plain_e3_adds_a_wide_heads_dx_as_the_chain_does():
    """Split under one thin head and a wide one: the thin head's rounded dX
    plus the wide head's GEMM output rounded, masked, split in hi + lo."""
    m, n = 45, 64
    h = torch.relu(_normal((m, n), 4)).to(BF16)
    g = _normal((m, 1), 5)
    hi, lo = tmlp._split(g, BF16)
    w = _normal((n, 1), 6).to(BF16)
    extra = _normal((m, n), 7)
    (ohi, olo), db = epi.plain_heads_relu_bwd(h, [(hi, lo, w)], True, extra)
    s = epi._thin_dx(hi, lo, w).float() + extra.to(BF16).float()
    s = torch.where(h <= 0, torch.zeros(()), s)
    assert torch.equal(ohi, s.to(BF16))
    assert torch.equal(olo, (s - s.to(BF16).float()).to(BF16))
    torch.testing.assert_close(db, s.sum(0), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        epi.heads_relu_bwd(h, [(hi, lo, w)], False, extra)


# ------------------------------------ fused stacks against the chain (CPU)


class _CardMatmul(torch.autograd.Function):
    """``models/mlp.py::_MatmulF32`` as it runs on the card, on the CPU:
    dX and dW f32-accumulated products rounded to bf16, a true f32 cotangent
    split in hi + lo."""

    @staticmethod
    def forward(ctx, x, w, g_rounded):
        ctx.save_for_backward(x, w)
        ctx.g_rounded = g_rounded
        return tmlp._mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        parts = [g.to(BF16)] if ctx.g_rounded else tmlp._split(g, BF16)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = tmlp._mm_sum([(p, w.t()) for p in parts]).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = tmlp._mm_sum([(x.t(), p) for p in parts]).to(w.dtype)
        return dx, dw, None


@pytest.fixture
def card_chain(monkeypatch):
    """``apply_mlp``'s chain with the card's GEMM backward, on the CPU."""
    def matmul(x, w, g_rounded=False, group=None, row_split=False):
        y = _CardMatmul.apply(x.reshape(-1, x.shape[-1]), w, g_rounded)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    monkeypatch.setattr(tmlp, "_matmul_f32", matmul)


def _layers(sizes, seed):
    return tmlp.init_mlp(torch.Generator().manual_seed(seed), sizes)["layers"]


def _grads(fn, layers, inputs, r):
    layers = [{k: v.clone().requires_grad_() for k, v in l.items()}
              for l in layers]
    outs = fn(layers, *inputs)
    loss = sum((o.float() * ri).sum() for o, ri in zip(outs, r))
    leaves = [x for x in inputs if x.requires_grad] + [
        l[k] for l in layers for k in ("w", "b")]
    return [o.detach() for o in outs], torch.autograd.grad(loss, leaves)


def _same(fused, chain, n_in):
    (out_f, g_f), (out_c, g_c) = fused, chain
    for a, b in zip(out_f, out_c):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for i in range(n_in):
        assert torch.equal(g_f[i], g_c[i]), f"input {i}"
    for j, (a, b) in enumerate(zip(g_f[n_in:], g_c[n_in:])):
        if j % 2 == 0:
            assert torch.equal(a, b), f"w of layer {j // 2}"
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [64, 37])
def test_fused_trunk_with_skip_and_bottleneck_matches_the_chain(
        card_chain, monkeypatch, m):
    """The published trunk at 3 ReLU layers of 64 with the skip into the
    third, under a density head (1) and a wide bottleneck (16) read in
    bf16, through ``apply_tower``'s fused stack and its chain: outputs,
    weight gradients and the input-free chain bit for bit."""
    d = 24
    trunk = [_layers([d, 64], 1)[0], _layers([64, 64], 2)[0],
             _layers([64 + d, 64], 3)[0]]
    heads = _layers([64, 1], 4) + _layers([64, 16], 5)
    x = _normal((m, d), 6)
    r = [_normal((m, 1), 7), _normal((m, 16), 8)]

    def tower(ls, xx):
        return tmlp.apply_tower({"layers": ls[:3]}, ls[3:], xx, ["relu"] * 3,
                                BF16, extras=[tmlp.Extra(2)],
                                rounded_head=True)

    chain = _grads(tower, trunk + heads, [x], r)
    monkeypatch.setattr(tmlp, "fused_relu_stack", lambda *a, **k: True)
    _same(_grads(tower, trunk + heads, [x], r), chain, 0)


@pytest.mark.parametrize("preset", ["garden_quality", "garden_paper"])
def test_nerf_forward_fused_wiring_matches_the_chain(card_chain, monkeypatch,
                                                     preset):
    """``nerf_forward`` of the repo's layout and the published one, at
    small widths the kernels take, with ``models/mlp.py::fused_relu_stack``
    forced True (the tower, and the view branch, through the plain E1-E3)
    against the chain: the model's fused wiring (its heads, the rounded
    bottleneck, the skip, the view branch) under the card's GEMM backward.
    Outputs and weight gradients bit for bit, bias gradients to summation
    order."""
    m = dataclasses.replace(
        get_config(preset).model, num_samples=8, nerf_samples=4,
        hidden_proposal=16, proposal_depth=2, hidden_nerf=32, nerf_depth=4,
        ipe_max_deg=2, compute_dtype="bfloat16",
        **(dict(trunk_skip=2, bottleneck_width=8, viewdir_width=16)
           if preset == "garden_paper" else {}))
    params = tm.init_model(m, torch.Generator().manual_seed(5))
    rays = _rays(12, 7)
    t = torch.sort(torch.rand(12, m.num_samples + 1,
                              generator=torch.Generator().manual_seed(8))
                   * 4 + 2, -1).values
    w = torch.rand(12, m.num_samples,
                   generator=torch.Generator().manual_seed(9))

    def run():
        tree = tm.map_params(lambda p: p.clone().requires_grad_(), params)
        out = tm.nerf_forward(tree, m, rays, t, w, False)
        loss = ((out["rgb"] ** 2).sum() + out["acc"].sum()
                + out["distance"].sum())
        leaves = weights.leaves(tree["nerf"])
        g = torch.autograd.grad(loss, [v for _, v in leaves])
        return out, dict(zip([k for k, _ in leaves], g))

    stacks, orig = [], tmlp.relu_stack_heads
    monkeypatch.setattr(tmlp, "relu_stack_heads", lambda hidden, heads, *a,
                        **k: stacks.append(len(heads)) or orig(hidden, heads,
                                                               *a, **k))
    o_c, g_c = run()
    assert stacks == []
    monkeypatch.setattr(tmlp, "fused_relu_stack", lambda *a, **k: True)
    o_f, g_f = run()
    # the trunk under its two heads, then the view branch under the rgb head
    assert stacks == ([2, 1] if preset == "garden_paper" else [2])
    for k in ("rgb", "acc", "weights", "distance"):
        assert torch.equal(o_f[k], o_c[k]), k
    for k in g_f:
        if k.endswith(".w"):
            assert torch.equal(g_f[k], g_c[k]), k
        else:
            torch.testing.assert_close(g_f[k], g_c[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("samples", [4, 1])
def test_fused_view_branch_matches_the_chain(card_chain, samples):
    """The view branch: a bf16 bottleneck of 16 that takes a gradient, the
    direction encoding (5 features) of each sample's ray (``samples`` a
    ray, expanded as ``nerf_forward`` does) into a ReLU layer of 32, the
    rgb head (3): outputs, dX and dW bit for bit."""
    rays = 12
    bn = _normal((rays, samples, 16), 9).to(BF16).requires_grad_()
    view = _normal((rays, 5), 10)[:, None, :].expand(rays, samples, 5)
    layers = _layers([16 + 5, 32, 3], 11)
    r = [_normal((rays, samples, 3), 12)]
    extras = [tmlp.Extra(0, view)]

    def chain(ls, xx):
        return [tmlp.apply_mlp({"layers": ls}, xx, ["relu", "sigmoid"], BF16,
                               extras=extras)]

    def fused(ls, xx):
        (y,) = tmlp.relu_stack_heads(ls[:1], ls[1:], xx, split=False,
                                     extras=extras)
        return [torch.sigmoid(y).to(torch.float32)]

    _same(_grads(fused, layers, [bn], r), _grads(chain, layers, [bn], r), 1)


def test_fused_stack_conditions_for_the_layout():
    x = torch.zeros(4, 8)
    hidden = _layers([8, 16, 16], 13)
    thin, wide = _layers([16, 1], 14), _layers([16, 64], 15)
    cuda_like = type("T", (), {"is_cuda": True, "requires_grad": False})()
    ok = lambda heads, **kw: tmlp.fused_relu_stack(
        cuda_like, BF16, None, hidden, ["relu", "relu"], heads, **kw)
    assert ok(thin + wide, rounded_head=True)
    assert not ok(thin + wide)
    assert not ok(thin + thin + wide, rounded_head=True)
    assert ok(thin, extras=[tmlp.Extra(1)])
    assert not ok(thin, extras=[tmlp.Extra(2)])
    assert not ok(thin, extras=[tmlp.Extra(1), tmlp.Extra(1)])
    assert ok(thin, extras=[tmlp.Extra(1, x)])
    assert ok(thin + wide, rounded_head=True, extras=[tmlp.Extra(1, x)])
    assert not ok(thin, extras=[tmlp.Extra(0, x.requires_grad_())])
    assert not tmlp.fused_relu_stack(x, BF16, None, hidden, ["relu", "relu"],
                                     thin)


# ------------------------------------------------------------ benchmark


def test_flop_counts_of_the_published_network():
    """By hand: the proposal MLP 1,697,280 FLOPs a sample on 128 samples,
    the NeRF MLPs 49,960,704 on 32; without the layout's keys, the repo's
    layout as the yardstick counts it."""
    from nerfbench import yardstick

    model = json.loads((REPO / "nerfbench" / "configs" /
                        "garden_paper.json").read_text())["model"]
    assert paper.flops_per_ray(model) == 128 * 1_697_280 + 32 * 49_960_704
    assert paper.flops_per_ray(model, train=False) == (
        128 * 2 * (504 * 256 + 3 * 256 * 256 + 256)
        + 32 * 2 * (504 * 1024 + 6 * 1024 * 1024 + 1528 * 1024 + 1024
                    + 1024 * 256 + 283 * 128 + 128 * 3))
    quality = json.loads((REPO / "nerfbench" / "configs" /
                          "garden_quality.json").read_text())["model"]
    for train in (True, False):
        assert paper.flops_per_ray(quality, train) == yardstick.flops_per_ray(
            quality, train)
    shapes = [(fi, fo) for _, layers, _ in paper.towers(quality)
              for fi, fo, _ in layers]
    assert shapes == [(s[i], s[i + 1]) for _, s, _ in
                      yardstick.mlp_towers(quality) for i in range(len(s) - 1)]


def test_composite_bound_of_the_published_network():
    """K1 and K2 at each proposal round's 64 samples and the NeRF level's
    32, on 2^14 rays; each launch counts at the mean of a step's."""
    from nerfbench import yardstick

    model = json.loads((REPO / "nerfbench" / "configs" /
                        "garden_paper.json").read_text())["model"]
    shapes = paper.composite_shapes(model, 16384)
    assert shapes == [[16384, 64], [16384, 64], [16384, 32]]
    need = paper.composite_bound_s({"K1": shapes, "K2": shapes}, 30, 30)
    assert need == pytest.approx(10 * sum(
        yardstick.k1_bound_s(*x) + yardstick.k2_bound_s(*x) for x in shapes))
    quality = json.loads((REPO / "nerfbench" / "configs" /
                          "garden_quality.json").read_text())["model"]
    assert paper.composite_shapes(quality, 4096) == [[4096, 64]] * 2
    assert paper.composite_bound_s({"K1": [4096, 64], "K2": [4096, 64]},
                                   4, 2) == pytest.approx(
        4 * yardstick.k1_bound_s(4096, 64) + 2 * yardstick.k2_bound_s(4096, 64))


def test_the_paper_driver_points_the_train_driver_at_the_layout():
    import importlib

    drv = importlib.import_module("nerfbench.drivers.train_paper")
    base = importlib.import_module("nerfbench.drivers.train")
    names = drv.Driver.start.__globals__
    assert names["ref"] is pref
    assert names["weights"].make_params is paper.make_params
    assert base.ref is ref and base.weights is weights


def _tiny_paper_root(tmp: Path) -> Path:
    import shutil

    root = tmp / "root"
    shutil.copytree(REPO / "nerfbench", root / "nerfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    path = root / "nerfbench" / "configs" / "garden_paper.json"
    conf = json.loads(path.read_text())
    tiny = {k: v for k, v in _model_dict(small_model()).items()
            if k in conf["model"]}
    train = {"batch_size": 64, "log_every": 4}
    conf["model"].update(tiny)
    conf["train"].update(train)
    conf["set"].update({f"model.{k}": v for k, v in tiny.items()})
    conf["set"].update({f"train.{k}": v for k, v in train.items()})
    conf["capture"] = {"name": "tiny_llff", "layout": "llff", "views": 17,
                       "width": 24, "height": 16, "factor": 8}
    path.write_text(json.dumps(conf))
    mix = root / "nerfbench" / "traffic" / "train_paper.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()),
                                   warmup_steps=8)))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_the_cell_runs_correct_at_a_tiny_size(tmp_path):
    """``garden_paper.train`` through the harness on the CPU at the small
    topology in float32: correct, every check far under its limit, and the
    new per-layer readers read the summary they are given."""
    from nerfbench import harness

    root = _tiny_paper_root(tmp_path)
    out = harness.run_cell("garden_paper.train", 2**31 + 9, 1.0, False,
                           "cpu", 0.0, root)
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] < 1e-3, (name, c)
    assert out["metrics"]["train_rays_per_s"]["value"] > 0
    cell = harness.find_cell("garden_paper.train", root)
    shapes = paper.composite_shapes(cell.config["model"], 64)
    summary = {"kind": "train", "model": cell.config["model"],
               "window": {"rate": 100.0, "chunk_s": [1.0]},
               "segment": {"steps": 4, "rays": 256,
                           "composite": {"K1": shapes, "K2": shapes}},
               "kernels": [("mlp_e1_bias_relu<false>", 8, 1e-3),
                           ("nvjet_tst_gemm", 10, 2e-3),
                           ("composite_fwd_regs<16, true>", 12, 1e-4),
                           ("composite_bwd_regs<16, true>", 12, 2e-4)],
               "busy_s": 1.0, "wall_s": 2.0}
    got = {m["name"]: harness.reader(cell, m["name"])(summary)
           for m in cell.per_layer}
    assert set(got) == {"chunk_ms_p95.train", "other_ms_per_step.train",
                        "idle_share.train", "mfu_paper.train",
                        "gemm_roofline_paper.train",
                        "composite_roofline_paper.train"}
    assert all(v is not None and v > 0 for v in got.values()), got
    # on the repo's layout the published network's readers read what
    # mfu.train, gemm_roofline.train and composite_roofline.train read
    quality = harness.find_cell("garden_quality.train", root).config["model"]
    other = dict(summary, model=quality, segment=dict(
        summary["segment"], composite={"K1": [64, 64], "K2": [64, 64]}))
    for name in ("mfu", "gemm_roofline", "composite_roofline"):
        assert harness.reader(cell, f"{name}_paper.train")(other) == \
            pytest.approx(harness.reader(cell, f"{name}.train")(other))


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_normal(shape, seed, device, scale=1.0):
    g = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(16384 * 32, 1024), (16384 * 32, 128),
                                 (4097 * 3, 256)])
def test_e1_with_a_second_input_matches_plain_on_card(cuda, m, n):
    """The published trunk's skip layer and the view layer at a garden_paper
    step's 524,288 NeRF rows, and ragged rows."""
    y, b = _card_normal((m, n), 1, cuda, 2.0), _card_normal((n,), 2, cuda)
    y1 = _card_normal((m, n), 3, cuda, 2.0)
    before = epi.launches["E1"]
    got = epi.bias_relu(y, b, y1)
    assert epi.launches["E1"] == before + 1
    assert torch.equal(got, epi.plain_bias_relu(y, b, y1))
    with pytest.raises(ValueError):
        epi.bias_relu(y, b, y1[:-1])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16384 * 32, 4097 * 32 + 3])
def test_e3_with_a_wide_heads_dx_matches_plain_on_card(cuda, m):
    n = 1024
    h = torch.relu(_card_normal((m, n), 4, cuda)).to(BF16)
    hi, lo = tmlp._split(_card_normal((m, 1), 5, cuda), BF16)
    w = _card_normal((n, 1), 6, cuda).to(BF16)
    extra = _card_normal((m, n), 7, cuda)
    outs, db = epi.heads_relu_bwd(h, [(hi, lo, w)], True, extra)
    want, want_db = epi.plain_heads_relu_bwd(h, [(hi, lo, w)], True, extra)
    assert all(torch.equal(a, b) for a, b in zip(outs, want))
    tol = 1e-6 * want[0].float().abs().sum(0) + 1e-30
    assert ((db - want_db).abs() <= tol).all()


def _launches():
    """G1's and E1-E3's launch counts."""
    return {**mlp_gemm.launches, **epi.launches}


def _card_tree(m, seed, device):
    return tm.map_params(lambda p: p.to(device),
                         paper.make_params(_model_dict(m), seed, "cpu"))


def _tower(params, m, device, fused, g1=None):
    """Outputs, NeRF gradients (of sum(rgb^2) + sum(acc)) and G1/E1-E3
    launches of the published NeRF tower on 256 rays x 32 samples: the
    fused stacks (``fused``; ``g1`` in place of ``mlp_gemm.bias_relu_taken``
    where given) or the layer-by-layer chain."""
    rays = rays_to_device(dummy_rays(256, seed=7), device)
    gen = torch.Generator(device).manual_seed(8)
    t = torch.sort(torch.rand(256, 65, generator=gen, device=device) * 4 + 2,
                   -1).values
    w = torch.rand(256, 64, generator=gen, device=device)
    with pytest.MonkeyPatch.context() as mp:
        if not fused:
            mp.setattr(tmlp, "fused_relu_stack", lambda *a, **k: False)
        if g1 is not None:
            mp.setattr(mlp_gemm, "bias_relu_taken", g1)
        tree = tm.map_params(lambda p: p.detach().clone().requires_grad_(),
                             params)
        before = _launches()
        out = tm.nerf_forward(tree, m, rays, t, w, False)
        loss = (out["rgb"] ** 2).sum() + out["acc"].sum()
        leaves = weights.leaves(tree["nerf"])
        g = torch.autograd.grad(loss, [v for _, v in leaves])
        return out, dict(zip([k for k, _ in leaves], g)), {
            k: _launches()[k] - before[k] for k in before}


@pytest.mark.cuda
def test_paper_tower_is_the_chain_bit_for_bit_on_card(cuda):
    """The published NeRF tower at its widths on 256 rays x 32 samples:
    the fused trunk (skip, density head, bottleneck) and view branch against
    the layer-by-layer chain, outputs and weight gradients bit for bit,
    bias gradients to summation order. G1 is replaced by its plain version
    (cuBLAS's f32 products and E1's arithmetic, what the chain's layers
    compute), so this holds the fused wiring; G1's own sums, in another
    order, are held by the next test."""
    m = PAPER
    params = _card_tree(m, 5, cuda)
    taken = []

    def plain_g1(inputs, w, b):
        taken.append(len(inputs))
        return mlp_gemm.plain_bias_relu(inputs[0], w, b, *inputs[1:])

    o_f, g_f, n_f = _tower(params, m, cuda, True, plain_g1)
    o_c, g_c, n_c = _tower(params, m, cuda, False)
    assert sorted(taken) == [1] * 7 + [2]
    assert n_f == {"G1": 0, "E1": 1, "E2": 7, "E3": 2}
    assert n_c == {"G1": 0, "E1": 0, "E2": 0, "E3": 0}
    for k in ("rgb", "acc", "weights", "distance"):
        assert torch.equal(o_f[k], o_c[k]), k
    for k in g_f:
        if k.endswith(".w"):
            assert torch.equal(g_f[k], g_c[k]), k
        else:
            torch.testing.assert_close(g_f[k], g_c[k], rtol=1e-4, atol=1e-6)


# The tower through G1 against the chain: G1's f32 sums run in another order
# than cuBLAS's (the skip layer's two products in one sum), so a few of its
# bf16 outputs differ by an ulp (phase 3e of chip_smoke.py, and
# tests/test_torch_mlp_gemm.py), and the difference reaches the outputs and
# gradients through the later layers and ReLU masks. Limits on the relative
# L2 difference (outputs; each gradient leaf): about four times the largest
# reading on an H100 at the three seeds below, outputs 3.2e-4 to 4.0e-4
# (the compositing weights the largest), gradient leaves 2.9e-3 to 3.6e-3
# (the trunk's first layer's w the largest).
TOWER_OUT_RTOL, TOWER_GRAD_RTOL = 2e-3, 1.5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_paper_tower_through_g1_matches_the_chain_on_card(cuda, seed):
    """The published NeRF tower as the main path runs it, 8 layers through
    G1 and the view layer through E1, against the chain: outputs and every
    NeRF gradient leaf by relative L2 under TOWER_OUT_RTOL and
    TOWER_GRAD_RTOL."""
    m = PAPER
    params = _card_tree(m, seed, cuda)
    o_f, g_f, n_f = _tower(params, m, cuda, True)
    o_c, g_c, n_c = _tower(params, m, cuda, False)
    assert n_f == {"G1": 8, "E1": 1, "E2": 7, "E3": 2}
    assert n_c == {"G1": 0, "E1": 0, "E2": 0, "E3": 0}
    rel = {k: ((o_f[k] - o_c[k]).norm() / o_c[k].norm()).item()
           for k in ("rgb", "acc", "weights", "distance")}
    grel = {k: ((g_f[k] - g_c[k]).norm() / g_c[k].norm()).item()
            for k in g_f}
    print(f"tower seed {seed}: outputs rel L2 max {max(rel.values()):.3e} "
          f"{rel}; gradient leaves rel L2 max {max(grel.values()):.3e} "
          f"{grel}")
    for k, r in rel.items():
        assert r < TOWER_OUT_RTOL, k
    for k, r in grel.items():
        assert r < TOWER_GRAD_RTOL, k


@pytest.mark.cuda
def test_garden_paper_step_launches_seventeen_e1(cuda, monkeypatch):
    """One garden_paper joint step of 1024 rays: 17 forward layers, G1 16
    (4 per proposal round, 8 trunk) and E1 1 (the view layer, whose 27
    direction features G1 cannot read), E2 13 (3 per round, 7 trunk), E3 4
    (one per round, the trunk's split, the view branch's); its gradients
    against the same step through the chain, per leaf by relative L2 at
    5e-2."""
    cfg = dataclasses.replace(get_config("garden_paper"), train=dataclasses.replace(
        get_config("garden_paper").train, batch_size=1024))
    params = _card_tree(cfg.model, 3, cuda)
    state = make_train_state(params, device=cuda,
                             generator=torch.Generator(cuda))
    rays = rays_to_device(dummy_rays(1024, seed=3), cuda)
    pixels = torch.rand(1024, 3, device=cuda)
    noise = tm.draw_render_noise(torch.Generator(cuda).manual_seed(2), 1024,
                                 64, cuda, rounds=2, nerf_samples=32)
    before = _launches()
    fused, aux = joint_cadence_grads(cfg, state, rays, pixels, noise=noise)
    assert {k: _launches()[k] - before[k] for k in before} == {
        "G1": 16, "E1": 1, "E2": 13, "E3": 4}
    monkeypatch.setattr(tmlp, "fused_relu_stack", lambda *a, **k: False)
    chain, aux_chain = joint_cadence_grads(cfg, state, rays, pixels,
                                           noise=noise)
    torch.testing.assert_close(aux["loss"], aux_chain["loss"], rtol=1e-2,
                               atol=0)
    for k in ("prop", "nerf"):
        for a, b in zip(fused[k], chain[k]):
            assert ((a - b).norm() / b.norm()).item() < 5e-2
