"""Port parity: the model, its params and the synthetic scene against the
JAX package, on the CPU, on the same params (through ``interop``) and the
same noise (the uniforms ``jax.random`` draws from the JAX split keys).

Tolerances: rtol 1e-4 / atol 1e-5 in float32, as
tests/test_pallas_ops.py::test_model_paths_agree holds the two JAX paths.
In bfloat16 the two packages round differently: XLA's CPU evaluates a bf16
sigmoid as 1/(1+exp(-x)) rounding every step to bf16, PyTorch rounds the f32
result once, so hidden features differ by up to one bf16 ulp (2^-8) and the
difference passes through the layers and both composites; there the
tolerance is rtol 2e-2 / atol 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipnerf360_tpu.config import ModelConfig as JaxModelConfig
from mipnerf360_tpu.config import get_config as jax_get_config
from mipnerf360_tpu.core.rays import dummy_rays as jax_dummy_rays
from mipnerf360_tpu.core.rays import rays_map as jax_rays_map
from mipnerf360_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from mipnerf360_tpu.models import mipnerf360 as jm
from mipnerf360_tpu.models import mlp as jmlp
from mipnerf360_torch import interop
from mipnerf360_torch.config import ModelConfig, get_config
from mipnerf360_torch.core.rays import dummy_rays, rays_to_device
from mipnerf360_torch.data.synthetic import synthetic_dataset
from mipnerf360_torch.models import mipnerf360 as tm
from mipnerf360_torch.models import mlp as tmlp

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
EPS = np.finfo(np.float32).eps

# tests/test_pallas_ops.py::test_model_paths_agree's config
SMALL = dict(num_samples=16, hidden_proposal=32, hidden_nerf=32, nerf_depth=2,
             compute_dtype="float32", use_pallas="off")
OUT_KEYS = ("rgb", "distance", "acc", "t_vals", "weights", "s_vals",
            "t_prop", "w_prop")


# jitted: the same function, compiled once instead of dispatched op by op
_jax_render_rays = jax.jit(jm.render_rays, static_argnums=(1, 4))


def _configs(**kw):
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _jax_params(cfg, seed=0):
    params = jm.init_model(jax.random.PRNGKey(seed), cfg)
    return params, interop.params_from_jax(jax.tree.map(np.asarray, params))


def _jax_noise(key, batch, n):
    """The uniforms JAX's render_rays draws from ``key`` (prop level, then
    the NeRF level's inverse-CDF jitter over n+1 samples)."""
    k1, k2 = jax.random.split(key)
    sample = jax.random.uniform(k1, (batch, n + 1))
    resample = jax.random.uniform(k2, (batch, n + 1), minval=0.0,
                                  maxval=1.0 / (n + 1) - EPS)
    return tm.RenderNoise(torch.tensor(np.asarray(sample)),
                          torch.tensor(np.asarray(resample)))


def _assert_outputs_close(got, want, tol, keys=OUT_KEYS):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mlp_matches_jax(dtype):
    params = jmlp.init_mlp(jax.random.PRNGKey(0), [58, 64, 64, 64, 4])
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, params))
    x = np.random.default_rng(0).normal(size=(5, 16, 58)).astype(np.float32)
    acts = ["relu", "relu", "sigmoid", "none"]
    want = jmlp.apply_mlp(params, jnp.asarray(x), acts, jnp.dtype(dtype))
    got = tmlp.apply_mlp(tparams, torch.from_numpy(x), acts, getattr(torch, dtype))
    assert got.dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_apply_linear_bf16_keeps_the_f32_product():
    """bf16 operands, f32 product and bias: no rounding before the bias."""
    params = jmlp.init_mlp(jax.random.PRNGKey(1), [40, 24])
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, params))
    x = np.random.default_rng(1).normal(size=(32, 40)).astype(np.float32)
    want = jmlp.apply_linear(params["layers"][0], jnp.asarray(x), jnp.bfloat16)
    got = tmlp.apply_linear(tparams["layers"][0], torch.from_numpy(x),
                            torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pad_input_lanes", [False, True])
def test_init_tree_matches_jax_shapes(pad_input_lanes):
    kw = dict(SMALL, ipe_max_deg=5, pad_input_lanes=pad_input_lanes)
    jcfg, tcfg = _configs(**kw)
    want = jax.tree.map(np.asarray, jm.init_model(jax.random.PRNGKey(0), jcfg))
    got = interop.params_to_numpy(
        tm.init_model(tcfg, torch.Generator().manual_seed(0)))
    assert (jax.tree.structure(got) == jax.tree.structure(want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
    first = got["nerf"]["trunk"]["layers"][0]["w"]
    pad = tcfg.padded_input_dim - tcfg.input_dim
    assert pad == (30 if pad_input_lanes else 0)
    assert not first[tcfg.input_dim:].any()


def test_init_is_seeded_and_kaiming_bounded():
    cfg = ModelConfig(**SMALL)
    a = tm.init_model(cfg, torch.Generator().manual_seed(3))
    b = tm.init_model(cfg, torch.Generator().manual_seed(3))
    c = tm.init_model(cfg, torch.Generator().manual_seed(4))
    la, lb, lc = (jax.tree.leaves(interop.params_to_numpy(p)) for p in (a, b, c))
    assert all(np.array_equal(x, y) for x, y in zip(la, lb))
    assert not all(np.array_equal(x, y) for x, y in zip(la, lc))
    for layer in a["nerf"]["trunk"]["layers"]:
        fan_in = layer["w"].shape[0]
        assert layer["w"].abs().max() <= np.sqrt(6.0 / fan_in)
        assert layer["b"].abs().max() <= 1.0 / np.sqrt(fan_in)


def test_interop_round_trip_and_module_nesting():
    jcfg, tcfg = _configs(**SMALL)
    jparams, tparams = _jax_params(jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    model = tm.MipNeRF360(tcfg, tparams)
    back = interop.params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(g, w)
    keys = set(model.state_dict())
    assert {"prop.layers.0.w", "nerf.trunk.layers.1.b", "nerf.rgb.layers.0.w",
            "nerf.density.layers.0.b"} <= keys
    assert len(keys) == len(jax.tree.leaves(tree))


def test_render_rays_randomized_matches_jax():
    jcfg, tcfg = _configs(**SMALL)
    jparams, tparams = _jax_params(jcfg)
    key = jax.random.PRNGKey(5)
    want = _jax_render_rays(jparams, jcfg,
                            jax_rays_map(jnp.asarray, jax_dummy_rays(48)), key, True)
    rays = rays_to_device(dummy_rays(48), "cpu")
    got = tm.render_rays(tparams, tcfg, rays, True, noise=_jax_noise(key, 48, 16))
    _assert_outputs_close(got, want, F32_TOL)
    # the nn.Module runs the same function
    mod = tm.MipNeRF360(tcfg, tparams)
    with torch.no_grad():
        again = mod(rays, True, noise=_jax_noise(key, 48, 16))
    for k in OUT_KEYS:
        torch.testing.assert_close(again[k], got[k], rtol=0, atol=0)


@pytest.mark.parametrize("variant", [
    dict(ray_shape="cylinder", factored_encode=False),
    dict(ipe_max_deg=3, pad_input_lanes=True, white_bkgd=True,
         trunk_final_sigmoid=False, density_head_sigmoid=False,
         density_bias=-5.0, resample_u_typo=True),
])
def test_render_rays_variants_match_jax(variant):
    jcfg, tcfg = _configs(**dict(SMALL, **variant))
    jparams, tparams = _jax_params(jcfg, seed=1)
    key = jax.random.PRNGKey(9)
    rays = dummy_rays(32, seed=2)
    for randomized in (False, True):
        want = _jax_render_rays(jparams, jcfg, jax_rays_map(jnp.asarray, rays),
                                key, randomized)
        noise = _jax_noise(key, 32, 16) if randomized else None
        got = tm.render_rays(tparams, tcfg, rays_to_device(rays, "cpu"),
                             randomized, noise=noise)
        _assert_outputs_close(got, want, F32_TOL)


def test_render_rays_bf16_matches_jax_loosely():
    jcfg, tcfg = _configs(**dict(SMALL, compute_dtype="bfloat16"))
    jparams, tparams = _jax_params(jcfg, seed=2)
    rays = dummy_rays(48, seed=3)
    want = _jax_render_rays(jparams, jcfg, jax_rays_map(jnp.asarray, rays),
                            jax.random.PRNGKey(0), False)
    got = tm.render_rays(tparams, tcfg, rays_to_device(rays, "cpu"), False)
    _assert_outputs_close(got, want, BF16_TOL)


def test_render_image_matches_jax_with_ragged_chunks():
    jcfg, tcfg = _configs(**SMALL)
    jparams, tparams = _jax_params(jcfg, seed=3)
    rays = dummy_rays(50, seed=4)           # 50 rays in chunks of 16: 2 pad
    want = jm.render_image(jparams, jcfg, jax_rays_map(jnp.asarray, rays), chunk=16)
    got = tm.render_image(tparams, tcfg, rays, chunk=16, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


def test_render_image_refuses_unported_parallel_modes():
    """The sample-axis render needs ranks to split the samples over: in one
    process it raises (the JAX package asserts on one device), and does not
    render on one rank instead."""
    cfg = ModelConfig(**dict(SMALL, sample_shards=2))
    params = tm.init_model(cfg)
    with pytest.raises(RuntimeError, match="needs a process group"):
        tm.render_image(params, cfg, dummy_rays(4), chunk=4, device="cpu")


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_split_matches_jax_exactly(split):
    cfg = get_config("synthetic_quality").data
    jcfg = jax_get_config("synthetic_quality").data
    cfg = dataclasses.replace(cfg, synthetic_resolution=16, synthetic_views=8)
    jcfg = dataclasses.replace(jcfg, synthetic_resolution=16, synthetic_views=8)
    got = synthetic_dataset(cfg, split, background=1.0)
    want = jax_synthetic(jcfg, split, background=1.0)
    assert (got.n_images, got.h, got.w, got.n_rays) == (
        want.n_images, want.h, want.w, want.n_rays)
    for g, w in zip(got.rays, want.rays):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.pixels, want.pixels)
    r0, p0 = got.image(1)
    np.testing.assert_array_equal(r0.origins, want.image(1)[0].origins)
    np.testing.assert_array_equal(p0, want.image(1)[1])


def test_synthetic_quality_test_split_size():
    """The held-out views the card renders: 7 views of 64x64; the render
    split the video renders: 28 poses of 64x64, made one pose at a time."""
    data = synthetic_dataset(get_config("synthetic_quality").data, "test")
    assert (data.n_images, data.h, data.w, data.n_rays) == (7, 64, 64, 28672)
    render = synthetic_dataset(get_config("synthetic_quality").data, "render")
    assert (render.n_images, render.h, render.w, render.n_rays) == (
        28, 64, 64, 28 * 4096)
    rays, pixels = render.image(27)
    assert pixels is None and rays.origins.shape == (4096, 3)


@pytest.mark.parametrize("g_rounded", [True, False])
def test_card_matmul_backward_matches_cpu_autograd(g_rounded):
    """The card's bf16 GEMM Function, run here on CPU bf16 tensors, against
    the CPU branch's autograd (the JAX package's semantics): dX and dW are
    products with f32 accumulation rounded to bf16. With a cotangent that
    holds bf16 values (a hidden layer) one GEMM gives them; with a true f32
    cotangent the hi + lo split does: it carries g to ~2^-16 relative, so an
    entry may differ by one bf16 ulp (2^-8 relative) and, where the sum
    cancels to near zero, by ~2^-16 of the output's scale."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(64, 40)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(40, 24)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(64, 24)).astype(np.float32))
    if g_rounded:
        g = g.bfloat16().float()
    grads = []
    for card in (True, False):
        xb = x.bfloat16().requires_grad_()
        wb = w.bfloat16().requires_grad_()
        y = (tmlp._MatmulF32.apply(xb, wb, g_rounded) if card
             else tmlp._mm_f32(xb, wb))
        assert y.dtype == torch.float32
        grads.append(torch.autograd.grad(y, [xb, wb], g))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype == torch.bfloat16
        tol = (dict(rtol=0, atol=0) if g_rounded else
               dict(rtol=8e-3, atol=2.0**-16 * want.float().abs().max().item()))
        torch.testing.assert_close(got.float(), want.float(), **tol)


def test_module_params_are_its_parameters_and_get_gradients():
    cfg = ModelConfig(**SMALL)
    mod = tm.MipNeRF360(cfg, generator=torch.Generator().manual_seed(5))
    tree_leaves = jax.tree.leaves(mod.params())
    assert {id(p) for p in tree_leaves} == {id(p) for p in mod.parameters()}
    out = mod(rays_to_device(dummy_rays(16), "cpu"))
    (out["rgb"].sum() + out["w_prop"].sum()).backward()
    assert all(p.grad is not None for p in mod.parameters())
