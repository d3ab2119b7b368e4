"""Port parity: ``mipnerf360_torch.core.sampling`` against
``mipnerf360_tpu.core.sampling`` on the CPU.

The randomized branches are fed the very uniforms that ``jax.random`` draws
from the same key, so both packages compute on the same numbers. Tolerance
atol 1e-5 in f32, as for the geometry; the deterministic grids must match bit
for bit, because a one-ulp shift of ``u`` can move a sample across a CDF edge.
"""
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

j_sampling = import_module("mipnerf360_tpu.core.sampling")
t_sampling = import_module("mipnerf360_torch.core.sampling")

torch.set_num_threads(1)

ATOL = 1e-5
EPS = np.finfo(np.float32).eps


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0.0)


def _histogram(seed=0, b=24, n=16):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(2.0, 6.0, (b, n + 1)), -1).astype(np.float32)
    weights = rng.uniform(0.0, 1.0, (b, n)).astype(np.float32)
    weights[0] = 0.0                   # all-zero row: the eps padding's case
    weights[1, 3:] = 0.0               # mass only at the front
    return bins, weights


@pytest.mark.parametrize("stop", [1.0, 1.0 - EPS, 0.7])
@pytest.mark.parametrize("num", [1, 2, 6, 17, 64, 65, 129])
def test_linspace_is_jnp_linspace_bit_for_bit(stop, num):
    want = np.asarray(jnp.linspace(0.0, stop, num, dtype=jnp.float32))
    got = t_sampling.linspace_from_zero(stop, num)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_torch_linspace_is_not_jnp_linspace():
    """Why linspace_from_zero exists: torch.linspace rounds differently."""
    want = np.asarray(jnp.linspace(0.0, 1.0 - EPS, 64, dtype=jnp.float32))
    got = torch.linspace(0.0, float(np.float32(1.0) - EPS), 64).numpy()
    assert np.count_nonzero(got != want) > 0


@pytest.mark.parametrize("randomized", [False, True])
def test_sample_along_rays_matches_jax(randomized):
    rng = np.random.default_rng(1)
    near = rng.uniform(0.5, 2.0, (12, 1)).astype(np.float32)
    far = near + rng.uniform(1.0, 10.0, (12, 1)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = j_sampling.sample_along_rays(key, jnp.asarray(near), jnp.asarray(far),
                                        16, randomized)
    noise = _t(jax.random.uniform(key, (12, 17))) if randomized else None
    got = t_sampling.sample_along_rays(_t(near), _t(far), 16, randomized,
                                       noise=noise)
    assert tuple(got.shape) == (12, 17)
    _close(got, want)


def test_sample_along_rays_draws_from_generator():
    near, far = _t(np.full((4, 1), 2.0)), _t(np.full((4, 1), 6.0))
    a = t_sampling.sample_along_rays(near, far, 8, True,
                                     generator=torch.Generator().manual_seed(1))
    b = t_sampling.sample_along_rays(near, far, 8, True,
                                     generator=torch.Generator().manual_seed(1))
    fixed = t_sampling.sample_along_rays(near, far, 8, False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, fixed)
    assert bool((a[:, 1:] >= a[:, :-1]).all())


def test_blur_weights_matches_jax():
    _, w = _histogram(2)
    _close(t_sampling.blur_weights(_t(w)), j_sampling.blur_weights(jnp.asarray(w)),
           atol=0.0)


@pytest.mark.parametrize("randomized,u_typo", [(False, False), (True, False),
                                               (True, True)])
def test_piecewise_constant_pdf_matches_jax(randomized, u_typo):
    bins, w = _histogram(3)
    n_out = 17
    key = jax.random.PRNGKey(7)
    want = j_sampling.sorted_piecewise_constant_pdf(
        key, jnp.asarray(bins), jnp.asarray(w), n_out, randomized, u_typo)
    noise = None
    if randomized:
        noise = _t(jax.random.uniform(key, (24, n_out), minval=0.0,
                                      maxval=1.0 / n_out - EPS))
    got = t_sampling.sorted_piecewise_constant_pdf(
        _t(bins), _t(w), n_out, randomized, u_typo, noise=noise)
    _close(got, want)
    assert bool((got[:, 1:] >= got[:, :-1]).all())


@pytest.mark.parametrize("randomized", [False, True])
def test_resample_along_rays_matches_jax_and_has_no_grad(randomized):
    bins, w = _histogram(4)
    key = jax.random.PRNGKey(11)
    want = j_sampling.resample_along_rays(key, jnp.asarray(bins), jnp.asarray(w),
                                          randomized, 0.01)
    noise = None
    if randomized:
        noise = _t(jax.random.uniform(key, (24, 17), minval=0.0,
                                      maxval=1.0 / 17 - EPS))
    weights = _t(w).requires_grad_()
    got = t_sampling.resample_along_rays(_t(bins), weights, randomized, 0.01,
                                         noise=noise)
    assert not got.requires_grad
    _close(got, want)
