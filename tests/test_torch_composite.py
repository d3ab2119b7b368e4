"""Kernel K1 (density -> compositing weights) and the rendering around it.

On the CPU: the port's plain version of K1 against the JAX package's Pallas
kernel run in interpret mode (as tests/test_pallas_ops.py runs it), at the
Pallas-vs-core tolerance rtol 1e-5 / atol 1e-6; its autograd gradient
against ``jax.grad`` through the Pallas custom VJP, at rtol 1e-4 / atol 1e-5;
the plain version of K2 (the backward) against the same VJP and against
autograd of the plain K1, at that tolerance; the autograd Function that
launches K1 and K2 on the card, with the launches replaced by the plain
versions; and the compositing around it. The kernels themselves are held
against the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mipnerf360_tpu.ops.pallas.composite import composite_weights as pallas_composite
from mipnerf360_torch.ops import composite, fused

j_render = import_module("mipnerf360_tpu.core.rendering")
t_render = import_module("mipnerf360_torch.core.rendering")

torch.set_num_threads(1)


def _inputs(b=300, n=64, seed=0, density_range=(0.0, 3.0)):
    rng = np.random.default_rng(seed)
    density = rng.uniform(*density_range, (b, n)).astype(np.float32)
    t_vals = np.sort(rng.uniform(0.1, 6.0, (b, n + 1)).astype(np.float32), -1)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    return density, t_vals, dirs


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


# N = 1 and 3: rows that are not 16-byte multiples; N = 128: the longest ray
# one register chunk of the card's kernels holds.
@pytest.mark.parametrize("b,n", [(300, 64), (300, 16), (37, 1), (37, 3),
                                 (20, 128)])
def test_plain_k1_matches_pallas_kernel(b, n):
    density, t_vals, dirs = _inputs(b, n)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_composite(*map(jnp.asarray, (density, t_vals, dirs)))
    got = composite.plain_composite_weights(_t(density), _t(t_vals), _t(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_plain_k1_gradient_matches_pallas_vjp():
    density, t_vals, dirs = _inputs(b=64, n=16, seed=2)
    tgt = np.random.default_rng(1).uniform(size=(64, 16)).astype(np.float32)

    def j_loss(d):
        w = pallas_composite(d, jnp.asarray(t_vals), jnp.asarray(dirs))
        return jnp.sum((w - tgt) ** 2) + jnp.sum(w * tgt)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(j_loss)(jnp.asarray(density))
    d = _t(density).requires_grad_()
    w = composite.plain_composite_weights(d, _t(t_vals), _t(dirs))
    loss = torch.sum((w - _t(tgt)) ** 2) + torch.sum(w * _t(tgt))
    (got,) = torch.autograd.grad(loss, [d])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("density_range", [(0.0, 1e-4), (50.0, 500.0)])
def test_compute_alpha_weights_matches_jax_at_extremes(density_range):
    """Near-zero density (the expm1 region) and opaque rays."""
    density, t_vals, dirs = _inputs(64, 16, seed=3, density_range=density_range)
    got_w, got_t = t_render.compute_alpha_weights(_t(density), _t(t_vals), _t(dirs))
    want_w, want_t = j_render.compute_alpha_weights(
        *map(jnp.asarray, (density, t_vals, dirs)))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_volumetric_rendering_matches_jax(white_bkgd):
    density, t_vals, dirs = _inputs(48, 16, seed=4)
    density[0] = 0.0          # empty ray: distance 0/0 -> clipped to t[0]
    rgb = np.random.default_rng(5).uniform(size=(48, 16, 3)).astype(np.float32)
    got = t_render.volumetric_rendering(_t(rgb), _t(density), _t(t_vals),
                                        _t(dirs), white_bkgd)
    want = j_render.volumetric_rendering(
        *map(jnp.asarray, (rgb, density, t_vals, dirs)), white_bkgd)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_cpu_dispatch_takes_plain_version_without_counting():
    density, t_vals, dirs = map(_t, _inputs(32, 16, seed=6))
    before = composite.launches
    for mode in ("auto", "on", "off"):
        w = fused.compute_alpha_weights(density, t_vals, dirs, mode)
        torch.testing.assert_close(
            w, composite.plain_composite_weights(density, t_vals, dirs),
            rtol=0, atol=0)
    assert composite.launches == before
    with pytest.raises(ValueError):
        fused.compute_alpha_weights(density, t_vals, dirs, "maybe")


def _pallas_vjp(density, t_vals, dirs, g):
    """d_density from ``jax.vjp`` of the Pallas kernel, in interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda d: pallas_composite(
            d, jnp.asarray(t_vals), jnp.asarray(dirs)), jnp.asarray(density))
        return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("b,n,density_range", [
    (64, 16, (0.0, 3.0)), (40, 65, (0.0, 3.0)),
    (64, 16, (0.0, 1e-4)),            # near-zero density, dd < 1e-2
    (64, 16, (50.0, 500.0)),          # opaque rays, T underflows to 0
    (37, 1, (0.0, 3.0)), (37, 3, (0.0, 3.0)),   # rows not 16-byte multiples
    (20, 128, (0.0, 3.0))])           # the longest ray in one chunk
def test_plain_k2_matches_pallas_vjp(b, n, density_range):
    density, t_vals, dirs = _inputs(b, n, seed=7, density_range=density_range)
    g = np.random.default_rng(8).normal(size=(b, n)).astype(np.float32)
    want = _pallas_vjp(density, t_vals, dirs, g)
    got = composite.plain_composite_weights_bwd(*map(_t, (density, t_vals, dirs, g)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("density_range", [(0.0, 3.0), (0.0, 1e-4), (50.0, 500.0)])
def test_plain_k2_matches_autograd_of_plain_k1(density_range):
    density, t_vals, dirs = map(_t, _inputs(48, 33, seed=9,
                                            density_range=density_range))
    g = _t(np.random.default_rng(10).normal(size=(48, 33)))
    d = density.clone().requires_grad_()
    w = composite.plain_composite_weights(d, t_vals, dirs)
    (want,) = torch.autograd.grad(w, [d], g)
    got = composite.plain_composite_weights_bwd(density, t_vals, dirs, g)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_function_routes_backward_through_k2(monkeypatch):
    """The Function the card uses, with K1 and K2 replaced by their plain
    versions: it saves the inputs, makes the cotangent contiguous, gives
    t_vals and dirs no gradient, and matches plain autograd."""
    calls = []

    def fake_bwd(density, t_vals, dirs, g):
        calls.append(g.is_contiguous())
        return composite.plain_composite_weights_bwd(density, t_vals, dirs, g)

    monkeypatch.setattr(composite, "_launch", composite.plain_composite_weights)
    monkeypatch.setattr(composite, "_launch_bwd", fake_bwd)
    density, t_vals, dirs = map(_t, _inputs(32, 16, seed=11))
    d = density.clone().requires_grad_()
    t = t_vals.clone().requires_grad_()
    w = composite.CompositeWeights.apply(d, t, dirs)
    # an expanded, non-contiguous cotangent, as a broadcast loss gives
    g = _t(np.random.default_rng(12).normal(size=(1, 16))).expand(32, 16)
    got_d, got_t = torch.autograd.grad(w, [d, t], g, allow_unused=True)
    assert calls == [True] and got_t is None
    d2 = density.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        composite.plain_composite_weights(d2, t_vals, dirs), [d2], g)
    torch.testing.assert_close(got_d, want, rtol=1e-4, atol=1e-5)
