"""Port parity: geometry and encoding of ``mipnerf360_torch.core`` against
``mipnerf360_tpu.core`` on the same NumPy inputs, in float32 on the CPU.

Tolerance: atol 1e-5, as tests/test_core_geometry.py and
tests/test_fused_encode.py hold the JAX functions; the two packages evaluate
the same formulas, so only the last ulp of each op differs.
"""
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# (import_module: the core packages re-export functions named like modules)
j_contract = import_module("mipnerf360_tpu.core.contract")
j_enc = import_module("mipnerf360_tpu.core.encoding")
j_fused = import_module("mipnerf360_tpu.core.fused_encode")
j_gauss = import_module("mipnerf360_tpu.core.gaussians")
j_rays = import_module("mipnerf360_tpu.core.rays")
j_spacing = import_module("mipnerf360_tpu.core.spacing")
t_contract = import_module("mipnerf360_torch.core.contract")
t_enc = import_module("mipnerf360_torch.core.encoding")
t_fused = import_module("mipnerf360_torch.core.fused_encode")
t_gauss = import_module("mipnerf360_torch.core.gaussians")
t_rays = import_module("mipnerf360_torch.core.rays")
t_spacing = import_module("mipnerf360_torch.core.spacing")

torch.set_num_threads(1)

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=rtol)


def _ray_inputs(seed=0, b=32, n=16, spread=8.0):
    """Rays whose sample points straddle the unit ball (as
    tests/test_fused_encode.py builds them)."""
    rng = np.random.default_rng(seed)
    origins = rng.normal(0, 0.1, (b, 3)).astype(np.float32)
    directions = rng.normal(size=(b, 3)).astype(np.float32)
    radii = rng.uniform(0.001, 0.05, (b, 1)).astype(np.float32)
    t = np.sort(rng.uniform(0.05, spread, (b, n + 1)), axis=-1).astype(np.float32)
    return t, origins, directions, radii


def test_spacing_matches_jax():
    rng = np.random.default_rng(0)
    near = rng.uniform(0.5, 2.0, (16, 1)).astype(np.float32)
    far = near + rng.uniform(0.01, 50.0, (16, 1)).astype(np.float32)
    s = np.sort(rng.uniform(0, 1, (16, 9)), -1).astype(np.float32)
    t = j_spacing.s_to_t(jnp.asarray(s), near, far)
    _close(t_spacing.s_to_t(_t(s), _t(near), _t(far)), t, rtol=1e-6)
    _close(t_spacing.t_to_s(_t(np.asarray(t)), _t(near), _t(far)),
           j_spacing.t_to_s(t, near, far))
    _close(t_spacing.g(_t(near)), j_spacing.g(jnp.asarray(near)), rtol=1e-6)


def test_spacing_endpoints_exact():
    near, far = _t([[2.0]]), _t([[6.0]])
    t = t_spacing.s_to_t(_t([0.0, 1.0]), near, far)
    assert t[0, 0].item() == 2.0 and t[0, 1].item() == 6.0


@pytest.mark.parametrize("scale", [0.3, 1.0, 5.0, 100.0])
def test_contract_and_jacobian_match_jax(scale):
    x = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32) * scale
    _close(t_contract.contract(_t(x)), j_contract.contract(jnp.asarray(x)))
    _close(t_contract.contract_jacobian(_t(x)),
           j_contract.contract_jacobian(jnp.asarray(x)))
    a = np.random.default_rng(2).normal(size=(64, 3, 3)).astype(np.float32)
    cov = a @ np.swapaxes(a, -1, -2) * 0.01
    got_m, got_c = t_contract.contract_gaussian(_t(x), _t(cov))
    want_m, want_c = j_contract.contract_gaussian(jnp.asarray(x), jnp.asarray(cov))
    _close(got_m, want_m)
    _close(got_c, want_c)


@pytest.mark.parametrize("stable", [True, False])
def test_conical_moments_match_jax(stable):
    _, _, _, radii = _ray_inputs(seed=4)
    # Intervals at least 0.2 wide: the unstable closed form divides
    # differences (t1^k - t0^k) that cancel for narrow intervals, where one
    # ulp of pow in either package moves the result by far more than ATOL.
    rng = np.random.default_rng(4)
    t = np.cumsum(rng.uniform(0.2, 0.5, (32, 17)), -1).astype(np.float32)
    t0, t1 = t[:, :-1], t[:, 1:]
    got = t_gauss.conical_frustum_to_gaussian(_t(t0), _t(t1), _t(radii), stable)
    want = j_gauss.conical_frustum_to_gaussian(
        jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(radii), stable)
    if stable:
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got[0], want[0], rtol=1e-5)   # t_mean
        _close(got[2], want[2], rtol=1e-5)   # r_var
        # t_var = E[t^2] - t_mean^2 cancels at t^2 ~ 50, where an f32 ulp
        # is 4e-6
        _close(got[1], want[1], atol=1e-4)


def test_cylinder_moments_and_lift_match_jax():
    t, _, d, radii = _ray_inputs(seed=5)
    t0, t1 = t[:, :-1], t[:, 1:]
    got = t_gauss.cylinder_to_gaussian(_t(t0), _t(t1), _t(radii))
    want = j_gauss.cylinder_to_gaussian(jnp.asarray(t0), jnp.asarray(t1),
                                        jnp.asarray(radii))
    for g, w in zip(got, want):
        _close(g, w)
    for diag in (False, True):
        gm, gc = t_gauss.lift_gaussian(_t(d), *got, diag=diag)
        wm, wc = j_gauss.lift_gaussian(jnp.asarray(d), *want, diag=diag)
        _close(gm, wm)
        _close(gc, wc)


@pytest.mark.parametrize("ray_shape", ["cone", "cylinder"])
def test_cast_rays_and_ipe_match_jax(ray_shape):
    t, o, d, r = _ray_inputs(seed=6)
    got_m, got_c = t_gauss.cast_rays(_t(t), _t(o), _t(d), _t(r), ray_shape)
    want_m, want_c = j_gauss.cast_rays(*map(jnp.asarray, (t, o, d, r)), ray_shape)
    _close(got_m, want_m)
    _close(got_c, want_c)
    _close(t_enc.integrated_pos_enc(got_m, got_c, 0, 5),
           j_enc.integrated_pos_enc(want_m, want_c, 0, 5))
    _close(t_enc.integrated_pos_enc(got_m, None, 1, 3),
           j_enc.integrated_pos_enc(want_m, None, 1, 3))


@pytest.mark.parametrize("ray_shape", ["cone", "cylinder"])
@pytest.mark.parametrize("spread,degs", [(0.5, (0, 1)), (8.0, (0, 5)),
                                         (200.0, (0, 5))])
def test_factored_ipe_matches_jax(ray_shape, spread, degs):
    t, o, d, r = _ray_inputs(seed=7, spread=spread)
    got = t_fused.factored_ipe(_t(t), _t(o), _t(d), _t(r), ray_shape=ray_shape,
                               min_deg=degs[0], max_deg=degs[1])
    want = j_fused.factored_ipe(*map(jnp.asarray, (t, o, d, r)),
                                ray_shape=ray_shape, min_deg=degs[0],
                                max_deg=degs[1])
    _close(got, want)
    # ... and the port's own general path (the oracle of factored_ipe)
    m, c = t_gauss.cast_rays(_t(t), _t(o), _t(d), _t(r), ray_shape)
    _close(got, t_enc.integrated_pos_enc(m, c, degs[0], degs[1]), atol=2e-5)


@pytest.mark.parametrize("ray_shape", ["cone", "cylinder"])
def test_factored_ipe_gradients_match_jax(ray_shape):
    t, o, d, r = _ray_inputs(seed=3)

    def j_loss(tv, o_, d_):
        return jnp.sum(jnp.cos(j_fused.factored_ipe(
            tv, o_, d_, jnp.asarray(r), ray_shape=ray_shape, max_deg=3)))

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (t, o, d)))
    args = [_t(x).requires_grad_() for x in (t, o, d)]
    loss = torch.sum(torch.cos(t_fused.factored_ipe(
        *args, _t(r), ray_shape=ray_shape, max_deg=3)))
    got = torch.autograd.grad(loss, args)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-4, rtol=1e-4)


def test_factored_ipe_gradient_finite_at_contraction_center():
    """A sample mean exactly at the origin (the _NORM_EPS clamp's case)."""
    t = _t([[1.9, 2.1]])
    o = _t([[-2.0, 0.0, 0.0]]).requires_grad_()
    d = _t([[1.0, 0.0, 0.0]])
    r = _t([[0.01]])
    loss = torch.sum(t_fused.factored_ipe(t, o, d, r, ray_shape="cylinder"))
    (g,) = torch.autograd.grad(loss, [o])
    assert torch.isfinite(g).all()


def test_factored_ipe_rejects_unknown_ray_shape():
    args = [_t(x) for x in _ray_inputs()]
    with pytest.raises(ValueError):
        t_fused.factored_ipe(*args, ray_shape="prism")


def test_viewdir_enc_matches_jax_including_pole():
    v = np.random.default_rng(8).normal(size=(40, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    # x == -1e-6, y == 0 makes y / (x + 1e-6) a 0/0 without the guard
    v[0] = [-1e-6, 0.0, 1.0]
    v[1] = [-1e-6, 0.5, 0.5]
    got = t_enc.viewdir_enc(_t(v), 0, 4)
    want = j_enc.viewdir_enc(jnp.asarray(v), 0, 4)
    assert torch.isfinite(got).all()
    _close(got, want)
    assert got.shape[-1] == t_enc.viewdir_enc_dim(0, 4)


def test_p_basis_and_dims_match_jax():
    np.testing.assert_array_equal(t_enc.P_BASIS, j_enc.P_BASIS)
    assert t_enc.POS_ENC_DIM == j_enc.POS_ENC_DIM
    assert t_enc.pos_enc_dim(0, 5) == j_enc.pos_enc_dim(0, 5)


def test_scale_ipe_matches_jax():
    rng = np.random.default_rng(9)
    gamma = rng.normal(size=(8, 21)).astype(np.float32)
    sigma = rng.uniform(0, 0.1, (8, 21)).astype(np.float32)
    _close(t_enc.scale_ipe(_t(gamma), _t(sigma), 0, 5),
           j_enc.scale_ipe(jnp.asarray(gamma), jnp.asarray(sigma), 0, 5))


def test_rays_helpers_match_jax():
    got, want = t_rays.dummy_rays(10, seed=3), j_rays.dummy_rays(10, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    dev = t_rays.rays_to_device(got, "cpu")
    assert all(x.dtype == torch.float32 and x.device.type == "cpu" for x in dev)
    idx = np.array([1, 4, 7])
    for g, w in zip(t_rays.take_rays(dev, torch.from_numpy(idx)),
                    j_rays.take_rays(want, idx)):
        np.testing.assert_array_equal(g.numpy(), w)
    stacked = t_rays.rays_map(lambda x: x.reshape(2, 5, -1), dev)
    for g, w in zip(t_rays.flatten_rays(stacked), want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert t_rays.num_rays(dev) == j_rays.num_rays(want) == 10
