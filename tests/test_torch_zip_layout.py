"""Zip-NeRF on the port (``garden_zip``): the multisampled, downweighted
hash-grid encode, three grid-backed sampling levels with their own MLPs, the
density in the bottleneck's channel 0 and the two-layer view branch.

On the CPU, at a small size of the same topology (small tables, some of
their levels hashed), on seeded weights whose tables vary at the scale the
benchmark seeds them:

- the layout's config fields, their checks, the preset against the
  benchmark's configuration file, and every other preset's forward and
  first gradient bit for bit as they were before the grid layout
  (``tests/data/preset_steps_before_grid.npz``, written by the parent
  commit's code);
- the port against the plain float32 reference of the benchmark
  (``nerfbench/reference/zip_model.py``): the multisample means and stds of
  both patterns, the isotropic contraction, the downweighted grid features,
  every level's forward, the losses and every parameter's first gradient
  (the tables' included), three trained steps and ``render_image``;
- the step's noise, the layout's refusals and spans, the trainer and a
  checkpoint's round trip, the benchmark's weights, counts, readers and the
  cell at a tiny size.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mipnerf360_torch.config import (PRESETS, Config, ModelConfig,
                                     TrainConfig, get_config)
from mipnerf360_torch.core.contract import contract_isotropic
from mipnerf360_torch.core.gaussians import multisample_cast
from mipnerf360_torch.core import hashgrid as hg
from mipnerf360_torch.core.rays import Rays, dummy_rays, rays_to_device
from mipnerf360_torch.models import mipnerf360 as tm
from mipnerf360_torch.ops import hashgrid
from mipnerf360_torch.train.state import (init_train_state, load_state_dict,
                                          make_train_state, state_dict)
from mipnerf360_torch.train.step import joint_cadence_grads, make_train_step
from mipnerf360_torch.utils import trace
from nerfbench import weights
from nerfbench import zip as zipnerf
from nerfbench.reference import model as ref
from nerfbench.reference import zip_model as zref

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
ZIP = get_config("garden_zip").model
NEW_FIELDS = ("viewdir_depth", "encoding", "grid_levels", "grid_min_res",
              "grid_max_res", "grid_features", "grid_log2_table")


def small_model(**kw) -> ModelConfig:
    """The Zip-NeRF topology at a small size: two rounds of 8 proposal
    samples and 4 NeRF samples, grids of 10 levels to 32, 64 and 128 in
    tables of 2^12 entries (the finer levels hashed), MLPs of 16, a
    bottleneck of 8 and a view branch of 2 x 16, in float32."""
    return dataclasses.replace(
        ZIP, **dict(dict(num_samples=8, nerf_samples=4,
                         grid_max_res="32,64,128", grid_log2_table=12,
                         hidden_proposal=16, hidden_nerf=16,
                         bottleneck_width=8, viewdir_width=16,
                         compute_dtype="float32"), **kw))


def _model_dict(m: ModelConfig) -> dict:
    return dataclasses.asdict(m)


def _train_dict() -> dict:
    return dataclasses.asdict(get_config("garden_zip").train)


def _rays(n, seed):
    return rays_to_device(dummy_rays(n, seed=seed), "cpu")


def _ref_rays(r: Rays) -> dict:
    return {k: getattr(r, k) for k in r._fields}


# ----------------------------------------------------------- the config


def test_garden_zip_is_the_zip_layout_and_the_benchmarks_file():
    from nerfbench import harness

    cfg = get_config("garden_zip")
    m = cfg.model
    assert (m.encoding, m.proposal_rounds, m.num_samples, m.nerf_samples) \
        == ("hashgrid", 2, 64, 32)
    assert m.grid_resolutions == (512, 2048, 8192)
    assert m.grid_level_features == (1, 1, 4)
    assert (m.grid_levels, m.grid_min_res, m.grid_log2_table) == (10, 16, 21)
    assert [m.grid_dim(i) for i in range(3)] == [10, 10, 40]
    assert m.input_dim == 40 and m.viewdir_dim == 27
    assert cfg.train.batch_size == 2**16
    assert (cfg.train.lr_init, cfg.train.lr_final,
            cfg.train.lr_delay_steps, cfg.train.max_steps) == (
                1e-2, 1e-3, 5000, 25000)
    cell = harness.find_cell("garden_zip.train", REPO)
    harness.port_config(cell, REPO / "nerfbench" / ".cache")
    assert cell.config["preset"] == "garden_zip"


@pytest.mark.parametrize("preset", sorted(set(PRESETS) - {"garden_zip"}))
def test_every_other_preset_keeps_the_new_fields_at_their_defaults(preset):
    m, default = get_config(preset).model, ModelConfig()
    for k in NEW_FIELDS:
        assert getattr(m, k) == getattr(default, k), k
    assert not (m.distinct_proposals or m.bottleneck_density)
    d = json.loads(get_config(preset).to_json())["model"]
    assert not set(NEW_FIELDS) & set(d)


@pytest.mark.parametrize("bad", [
    dict(encoding="grid"), dict(viewdir_depth=0),
    dict(encoding="hashgrid", grid_max_res="512,8192"),
    dict(encoding="hashgrid", bottleneck_width=0, viewdir_width=0),
    dict(encoding="hashgrid", pad_input_lanes=True),
    dict(encoding="hashgrid", grid_levels=17),
])
def test_the_layout_fields_refuse_what_has_no_meaning(bad):
    with pytest.raises(ValueError):
        dataclasses.replace(ZIP, **bad)


def _shrunk(name):
    """A preset at the small size the fixture was written at."""
    cfg = get_config(name)
    m = cfg.model
    m = dataclasses.replace(
        m, num_samples=8, hidden_proposal=16, hidden_nerf=16,
        nerf_depth=min(m.nerf_depth, 4), trunk_skip=min(m.trunk_skip, 2),
        ipe_max_deg=min(m.ipe_max_deg, 3),
        bottleneck_width=8 if m.bottleneck_width else 0,
        viewdir_width=16 if m.viewdir_width else 0,
        nerf_samples=4 if m.nerf_samples else 0)
    return dataclasses.replace(cfg, model=m, train=dataclasses.replace(
        cfg.train, batch_size=16))


@pytest.mark.parametrize("preset", sorted(set(PRESETS) - {"garden_zip"}))
def test_every_other_preset_steps_bit_for_bit_as_before_the_grid(preset):
    """The first step's loss and gradients and the render of each preset
    (at a small size, on the CPU) equal, bit for bit, what the code before
    the grid layout computed."""
    torch.set_num_threads(1)
    try:
        cfg = _shrunk(preset)
        before = np.load(REPO / "tests" / "data"
                         / "preset_steps_before_grid.npz")
        rays = _rays(16, 3)
        state = init_train_state(cfg.model, cfg.train, device="cpu")
        pixels = torch.rand(16, 3, generator=torch.Generator().manual_seed(1))
        grads, aux = joint_cadence_grads(cfg, state, rays, pixels)
        with torch.no_grad():
            out = tm.render_rays(state.params, cfg.model, rays, False)
    finally:
        torch.set_num_threads(2)
    assert np.array_equal(out["rgb"].numpy(), before[f"{preset}.rgb"])
    assert np.array_equal(aux["loss"].numpy(), before[f"{preset}.loss"])
    for k in ("prop", "nerf"):
        got = torch.cat([g.reshape(-1) for g in grads[k]]).numpy()
        assert np.array_equal(got, before[f"{preset}.grad.{k}"]), k


# ------------------------------------------- the port against the reference


@pytest.fixture(scope="module")
def case():
    m = small_model()
    model = _model_dict(m)
    params = zipnerf.make_params(model, 2**31 + 13, "cpu")
    rays = _ref_rays(_rays(48, 5))
    # cones wide enough that the downweights span (0, 1) at these grids
    rays["radii"] = rays["radii"] * 60
    noise = zref.draw_noise(torch.Generator().manual_seed(4), 48, model)
    return m, model, params, rays, noise


def _close(a, b, atol=2e-5):
    torch.testing.assert_close(a, b, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("randomized", [True, False])
def test_multisample_means_and_stds_match_the_reference(case, randomized):
    m, model, params, rays, noise = case
    t = torch.sort(torch.rand(48, 9, generator=torch.Generator()
                              .manual_seed(1)) * 8 + 0.1, -1).values
    pat = zref.patterns(model, noise)[0] if randomized else None
    means, stds = multisample_cast(t, rays["origins"], rays["directions"],
                                   rays["radii"], *(pat or (None, None)))
    want_m, want_s = zref.cast(rays, t, pat)
    assert means.shape == (48, 8, 6, 3) and stds.shape == (48, 8, 6)
    _close(means, want_m, 1e-5)
    _close(stds, want_s, 1e-8)


def test_the_render_pattern_turns_and_mirrors_every_odd_interval(case):
    _, _, _, rays, _ = case
    t = torch.linspace(1.0, 3.0, 5).expand(48, 5)
    means, _ = multisample_cast(t, rays["origins"], rays["directions"],
                                rays["radii"])
    turn = torch.zeros(48, 4)
    even, _ = multisample_cast(t, rays["origins"], rays["directions"],
                               rays["radii"], turn, torch.ones(48, 4))
    odd, _ = multisample_cast(t, rays["origins"], rays["directions"],
                              rays["radii"], turn + 1 / 12, torch.zeros(48, 4))
    _close(means[:, 0::2], even[:, 0::2], 1e-6)
    _close(means[:, 1::2], odd[:, 1::2], 1e-6)


def test_isotropic_contraction_matches_the_reference():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(500, 3, generator=g) * 3
    s = torch.rand(500, generator=g) * 0.1
    got = contract_isotropic(x, s)
    want = zref.contract(x, s)
    _close(got[0], want[0], 1e-6)
    _close(got[1], want[1], 1e-7)
    inside = (x * x).sum(-1) <= 1
    assert torch.equal(got[1][inside], s[inside])


@pytest.mark.parametrize("level", [0, 2])
def test_downweighted_grid_features_match_the_reference(case, level):
    m, model, params, rays, noise = case
    t = torch.sort(torch.rand(48, 5, generator=torch.Generator()
                              .manual_seed(3)) * 8 + 0.1, -1).values
    table = params["nerf"]["grid"] if level == 2 else params["prop"][0]["grid"]
    pat = (noise[2][:, :4], noise[2][:, 4:8])
    got = hashgrid.encode_grid(table, t, Rays(**rays),
                               hg.model_grid_spec(m, level), pat)
    want = zref.grid_encode(model, level, table, rays, t, pat)
    _close(got, want)
    plain = zref.grid_encode(model, level, table, rays, t, pat,
                             downweight=False)
    assert float((plain - want).abs().max()) > 1e-3


@pytest.mark.parametrize("randomized", [True, False])
def test_forward_of_every_level_matches_the_reference(case, randomized):
    m, model, params, rays, noise = case
    noise = noise if randomized else None
    with torch.no_grad():
        got = tm.render_rays(params, m, Rays(**rays), randomized,
                             noise=None if noise is None
                             else tm.RenderNoise(*noise))
        want = zref.forward(model, params, rays, noise)
    assert len(got["props"]) == len(want["props"]) == 2
    for (t, w), (rt, rw) in zip(got["props"], want["props"]):
        assert t.shape == (48, 9)
        _close(t, rt)
        _close(w, rw)
    assert got["t_vals"].shape == (48, 5)
    for a, b in (("t_vals", "t"), ("weights", "w"), ("rgb", "rgb"),
                 ("acc", "acc"), ("distance", "distance")):
        _close(got[a], want[b])
    # the seeded tables make the density vary: weights far from zero
    assert float(want["w"].max()) > 1e-2


def _port_step(m, params, rays, pixels, noise):
    cfg = Config(model=m, train=get_config("garden_zip").train)
    state = make_train_state(params, device="cpu",
                             generator=torch.Generator())
    return joint_cadence_grads(cfg, state, Rays(**rays), pixels,
                               noise=tm.RenderNoise(*noise))


def test_losses_and_first_gradient_match_the_reference_tables_included(case):
    m, model, params, rays, noise = case
    pixels = torch.rand(48, 3, generator=torch.Generator().manual_seed(6))
    grads, aux = _port_step(m, params, rays, pixels, noise)
    tree = ref._map(lambda p: p.detach().clone().requires_grad_(), params)
    named = weights.leaves(tree)
    fwd = zref.forward(model, tree, rays, noise)
    want = zref.losses(_train_dict(), fwd, pixels, rays["near"], rays["far"])
    for k in ("loss", "loss_nerf", "loss_dist", "loss_prop", "psnr"):
        torch.testing.assert_close(aux[k], want[k].detach(), rtol=1e-4,
                                   atol=1e-6)
    ref_grads = torch.autograd.grad(want["loss"], [p for _, p in named])
    mine = {f"{k}.{name}": g for k in ("prop", "nerf")
            for (name, _), g in zip(weights.leaves(params[k]), grads[k])}
    assert set(mine) == {name for name, _ in named}
    assert {"prop.0.grid", "prop.1.grid", "nerf.grid"} <= set(mine)
    for (name, _), g in zip(named, ref_grads):
        scale = float(g.abs().max()) + 1e-12
        torch.testing.assert_close(mine[name] / scale, g / scale, rtol=0,
                                   atol=2e-4, msg=name)
        if name.endswith("grid"):
            assert float(g.abs().max()) > 0, name


def test_three_steps_match_the_reference(case):
    """The program's three joint steps from the benchmark's weights on the
    reference's noise against ``zip_model.train_steps``."""
    m, model, params, rays, _ = case
    train = dict(_train_dict(), lr_max_steps=25000)
    g = torch.Generator().manual_seed(8)
    batches = [(rays, torch.rand(48, 3, generator=g)) for _ in range(3)]
    want = zref.train_steps(model, train, params, batches,
                            torch.Generator().manual_seed(9))
    cfg = Config(model=m, train=get_config("garden_zip").train)
    state = make_train_state(params, device="cpu",
                             generator=torch.Generator())
    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(9)
    losses = []
    for r, pixels in batches:
        noise = tm.RenderNoise(*zref.draw_noise(gen, 48, model))
        state, aux = step(state, Rays(**r), pixels, noise=noise)
        losses.append(float(aux["loss"]))
    np.testing.assert_allclose(losses, [s["loss"] for s in want["losses"]],
                               rtol=1e-5)
    p0 = dict(weights.leaves(params))
    for name, p in weights.leaves(state.params):
        moved, want_moved = p.detach() - p0[name], want["params"][name] - p0[name]
        torch.testing.assert_close(moved, want_moved, rtol=1e-3,
                                   atol=1e-3 * float(want_moved.abs().max()),
                                   msg=name)


def test_render_image_matches_the_reference_render(case):
    m, model, params, _, _ = case
    rays = _ref_rays(_rays(70, 8))
    rgb, dist, acc = tm.render_image(params, m, Rays(**rays), chunk=32,
                                     device="cpu")
    want = zref.render(model, params, rays, block=16)
    _close(rgb, want["rgb"])
    _close(dist, want["distance"])
    _close(acc, want["acc"])


def test_step_noise_is_the_references_draw():
    """A randomized step without noise draws, from its generator, the
    reference's uniforms in order: the first round's edges, the second
    round's jitter, the NeRF level's, then the patterns."""
    m = small_model()
    model = _model_dict(m)
    a = tm.draw_render_noise(torch.Generator().manual_seed(9), 32, 8, "cpu",
                             rounds=2, nerf_samples=4,
                             pattern=tm.pattern_intervals(m))
    b = zref.draw_noise(torch.Generator().manual_seed(9), 32, model)
    assert a.pattern.shape == (32, 2 * (8 + 8 + 4))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_a_step_without_noise_draws_what_draw_render_noise_draws(case):
    m, model, params, rays, _ = case
    pixels = torch.rand(48, 3)
    cfg = Config(model=m, train=TrainConfig(batch_size=48))
    drawn = tm.draw_render_noise(torch.Generator().manual_seed(3), 48, 8,
                                 "cpu", rounds=2, nerf_samples=4,
                                 pattern=tm.pattern_intervals(m))

    def grads(noise):
        state = make_train_state(params, device="cpu",
                                 generator=torch.Generator().manual_seed(3))
        return joint_cadence_grads(cfg, state, Rays(**rays), pixels,
                                   noise=noise)

    (g0, a0), (g1, a1) = grads(None), grads(drawn)
    assert torch.equal(a0["loss"], a1["loss"])
    assert all(torch.equal(x, y) for x, y in zip(g0["nerf"], g1["nerf"]))


def test_the_layout_has_no_tensor_parallel_or_sample_axis_path(case):
    m, _, params, rays, _ = case
    with torch.no_grad(), pytest.raises(ValueError, match="view-branch"):
        tm.render_rays(params, m, Rays(**rays), False, tp_group=object())


def test_the_layout_opens_only_the_benchmarks_spans(case, monkeypatch):
    from nerfbench import spans as sp

    m, _, params, rays, _ = case
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


def test_init_model_and_the_module_hold_the_tables():
    m = small_model()
    params = tm.init_model(m)
    assert isinstance(params["prop"], list) and len(params["prop"]) == 2
    for r, p in enumerate(params["prop"]):
        spec = hg.model_grid_spec(m, r)
        assert p["grid"].shape == (spec.entries, 1)
        assert float(p["grid"].abs().max()) <= tm.GRID_INIT
        assert p["layers"][0]["w"].shape == (10, 16)
    assert params["nerf"]["grid"].shape == (
        hg.model_grid_spec(m, 2).entries, 4)
    assert "density" not in params["nerf"]
    assert [l["w"].shape for l in params["nerf"]["rgb"]["layers"]] == [
        (8 + 27, 16), (16, 16), (16, 3)]
    module = tm.MipNeRF360(m, params)
    names = dict(module.named_parameters())
    assert {"prop.0.grid", "prop.1.layers.1.w", "nerf_grid"} <= set(names)
    tree = module.params()
    assert [n for n, _ in weights.leaves(tree)] == [
        n for n, _ in weights.leaves(params)]
    # the benchmark's weights have the program's shapes
    bench = zipnerf.make_params(_model_dict(m), 5, "cpu")
    assert [(n, tuple(v.shape)) for n, v in weights.leaves(bench)] == [
        (n, tuple(v.shape)) for n, v in weights.leaves(params)]


def test_a_checkpoint_round_trip_keeps_the_tables(case):
    m, _, params, rays, _ = case
    cfg = Config(model=m, train=TrainConfig(batch_size=48))
    state = make_train_state(params, device="cpu",
                             generator=torch.Generator().manual_seed(1))
    state, _ = make_train_step(cfg)(state, Rays(**rays), torch.rand(48, 3))
    sd = state_dict(state)
    other = make_train_state(params, device="cpu",
                             generator=torch.Generator().manual_seed(2))
    load_state_dict(other, {k: v for k, v in sd.items()})
    for (n, a), (_, b) in zip(weights.leaves(state.params),
                              weights.leaves(other.params)):
        assert torch.equal(a, b), n
    assert torch.equal(other.opt_state["prop"].mu[1]["grid"],
                       state.opt_state["prop"].mu[1]["grid"])


def test_the_trainer_trains_and_evaluates_the_layout(tmp_path):
    """``train()`` on the synthetic scene a few steps with the layout, then
    ``render_image`` of a held-out view from its state."""
    from mipnerf360_torch.train.trainer import train

    m = small_model()
    cfg = Config(model=m, train=TrainConfig(
        max_steps=4, batch_size=32, log_every=2, save_every=4,
        checkpoint_dir=str(tmp_path), lr_delay_steps=0),
        data=dataclasses.replace(get_config("synthetic_quality").data,
                                 synthetic_resolution=8, synthetic_views=3))
    state = train(cfg, device="cpu")
    assert state.step == 4
    assert (tmp_path / "ckpt_4.pt").is_file()
    rgb, _, _ = tm.render_image(state.params, m, _rays(20, 2), chunk=8,
                                device="cpu")
    assert torch.isfinite(rgb).all()


# ------------------------------------------------------------ the benchmark


def test_flop_and_byte_counts_of_the_zip_network():
    model = json.loads((REPO / "nerfbench" / "configs" / "garden_zip.json")
                       .read_text())["model"]
    prop = 2 * 10 * 64 + 2 * 64 * 1
    nerf = 2 * 40 * 64 + 2 * 64 * 256 + 2 * 283 * 256 + 2 * 256 * 256 \
        + 2 * 256 * 3
    assert zipnerf.flops_per_ray(model, train=False) == 2 * 64 * prop \
        + 32 * nerf
    grad_in = 2 * 64 * 2 * (10 * 64 + 64 * 1) + 32 * 2 * (
        40 * 64 + 64 * 256 + 256 * 256 + 256 * 256 + 256 * 3)
    assert zipnerf.flops_per_ray(model) == 2 * zipnerf.flops_per_ray(
        model, train=False) + grad_in
    cfg = get_config("garden_zip").model
    for level in range(3):
        assert zipnerf.entries(model, level) == hg.model_grid_spec(
            cfg, level).entries
    work = zipnerf.grid_work(model, 65536)
    assert [w["points"] for w in work] == [65536 * 64 * 6] * 2 + [
        65536 * 32 * 6]
    b = 65536
    want = 0
    for n, width, level in ((64, 10, 0), (64, 10, 1), (32, 40, 2)):
        want += b * (4 * (n + 1) + 28 + 8 * n) + 2 * b * n * width * 2
        want += 4 * hg.model_grid_spec(cfg, level).entries * (
            4 if level == 2 else 1)
    assert zipnerf.grid_bytes(model, b) == want


def test_the_zip_readers_read_the_grid_kernels():
    from nerfbench import harness

    cell = harness.find_cell("garden_zip.train", REPO)
    model = cell.config["model"]
    summary = {"kind": "train", "model": model,
               "window": {"rate": 5e5, "chunk_s": [1.0]},
               "segment": {"steps": 20, "rays": 20 * 65536, "grid": [],
                           "composite": {"K1": [[65536, 64]], "K2": [[65536,
                                                                     64]]}},
               "kernels": [("void hashgrid_fwd<4, unsigned short>", 20, 0.2),
                           ("void hashgrid_bwd<1, unsigned short>", 40, 0.6),
                           ("nvjet_tst", 100, 0.1)],
               "busy_s": 1.0, "wall_s": 1.2}
    read = {m["name"]: harness.reader(cell, m["name"])(summary)
            for m in cell.per_layer}
    assert read["hashgrid_ms_per_step.train"] == pytest.approx(40.0)
    bound = zipnerf.grid_bound_s(model, 65536)
    assert read["hashgrid_roofline.train"] == pytest.approx(
        100 * 20 * bound / 0.8)
    assert read["mfu_zip.train"] == pytest.approx(
        100 * zipnerf.flops_per_ray(model) * 5e5 / 989e12)
    assert 0 < read["hashgrid_roofline.train"] < 100


def test_the_zip_driver_points_the_train_driver_at_the_layout():
    import importlib

    drv = importlib.import_module("nerfbench.drivers.train_zip")
    base = importlib.import_module("nerfbench.drivers.train")
    names = drv.Driver.start.__globals__
    assert names["ref"] is zref
    assert names["weights"].make_params is zipnerf.make_params
    assert base.ref is ref and base.weights is weights


def _tiny_zip_root(tmp: Path, compute_dtype="float32") -> Path:
    import shutil

    root = tmp / "root"
    shutil.copytree(REPO / "nerfbench", root / "nerfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    path = root / "nerfbench" / "configs" / "garden_zip.json"
    conf = json.loads(path.read_text())
    tiny = {k: v for k, v in _model_dict(small_model(
        compute_dtype=compute_dtype)).items() if k in conf["model"]}
    train = {"batch_size": 64, "log_every": 4}
    conf["model"].update(tiny)
    conf["train"].update(train)
    conf["set"].update({f"model.{k}": v for k, v in tiny.items()})
    conf["set"].update({f"train.{k}": v for k, v in train.items()})
    conf["capture"] = {"name": "tiny_llff", "layout": "llff", "views": 17,
                       "width": 24, "height": 16, "factor": 8}
    path.write_text(json.dumps(conf))
    mix = root / "nerfbench" / "traffic" / "train_zip.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()),
                                   warmup_steps=8)))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_the_cell_runs_correct_at_a_tiny_size(tmp_path):
    """``garden_zip.train`` through the harness on the CPU at the small
    topology in float32: correct, every check under a hundredth of its
    limit. The window is long enough for a chunk to close on a loaded
    machine."""
    from nerfbench import harness

    root = _tiny_zip_root(tmp_path)
    out = harness.run_cell("garden_zip.train", 2**31 + 9, 5.0, False,
                           "cpu", 0.0, root)
    assert out["correct"], out["checks"]
    assert "grid_grad_gap" in out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] < 1e-2 * c["limit"], (name, c)
    assert out["metrics"]["train_rays_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["no_downweight", "drop_half",
                                   "unchanged", "tables_unchanged"])
def test_the_cells_faults_fail_a_limit_at_a_tiny_size(tmp_path, fault):
    """Each fault planted in the reference in the program's place fails at
    least one of the cell's limits; omega = 1 fails the tables' gradient
    check, and a state or tables left unchanged the tables' change."""
    from nerfbench import capture, harness

    root = _tiny_zip_root(tmp_path)
    cell = harness.find_cell("garden_zip.train", root)
    cap, _ = capture.ensure(cell.config["capture"], cell.folder / ".cache")
    drv = harness.driver_class(cell)(cell, harness.port_config(cell, cap),
                                     cap, torch.device("cpu"))
    drv.start(2**31 + 3)
    drv.stop()
    got = drv.readings(fault=fault)
    failed = [k for k, lim in cell.limits.items()
              if not got[k] <= lim["limit"]]
    assert failed, got
    if fault == "no_downweight":
        assert "grid_grad_gap" in failed
    if fault.endswith("unchanged"):
        assert "grid_delta_gap" in failed
