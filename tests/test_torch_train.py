"""Port parity for the training slice: losses, schedule, AdamW and both
cadences' train steps against the JAX package, on the CPU.

Both sides start from the same params (through ``interop``), take the same
batch and the same noise: the uniforms ``jax.random`` draws from the keys the
JAX step splits off ``state.key``. The JAX side runs its jnp path
(``use_pallas="off"``), as its own tests do on the CPU.

Tolerances, float32:
- aux losses and per-leaf gradients after one step: rtol 1e-4 / atol 1e-6,
  only summation orders differ;
- params after 3 steps: rtol 2e-4 / atol 1e-6, the JAX package's own
  cross-reduction-order tolerance (tests/test_train.py::TestSharding).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mipnerf360_tpu import losses as jl
from mipnerf360_tpu.config import Config as JConfig
from mipnerf360_tpu.config import ModelConfig as JModelConfig
from mipnerf360_tpu.config import TrainConfig as JTrainConfig
from mipnerf360_tpu.core.rays import dummy_rays as jax_dummy_rays
from mipnerf360_tpu.core.rays import rays_map as jax_rays_map
from mipnerf360_tpu.losses import distillation as jdist
from mipnerf360_tpu.train import step as jstep
from mipnerf360_tpu.train.schedule import log_lerp_lr as jax_lr
from mipnerf360_tpu.train.state import TrainState as JTrainState
from mipnerf360_tpu.train.state import init_train_state as jax_init_state
from mipnerf360_torch import interop
from mipnerf360_torch import losses as tl
from mipnerf360_torch.config import Config, ModelConfig, TrainConfig
from mipnerf360_torch.core.rays import rays_to_device
from mipnerf360_torch.losses import distillation as tdist
from mipnerf360_torch.models import mipnerf360 as tm
from mipnerf360_torch.train import step as tstep
from mipnerf360_torch.train.schedule import log_lerp_lr
from mipnerf360_torch.train.state import leaves

torch.set_num_threads(1)

EPS = np.finfo(np.float32).eps
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
B, N = 48, 16

MODEL = dict(num_samples=N, hidden_proposal=32, hidden_nerf=32, nerf_depth=2,
             compute_dtype="float32", use_pallas="off", white_bkgd=True)
TRAIN = dict(max_steps=100, batch_size=B, lr_init=2e-3, lr_final=2e-4,
             lr_delay_steps=5)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _configs(cadence="joint", model=None, **train):
    m = dict(MODEL, **(model or {}))
    t = dict(TRAIN, cadence=cadence, **train)
    return (JConfig(model=JModelConfig(**m), train=JTrainConfig(**t)),
            Config(model=ModelConfig(**m), train=TrainConfig(**t)))


def _noise(key):
    """The uniforms a JAX ``_forward_both(..., key)`` draws."""
    k1, k2 = jax.random.split(key)
    sample = jax.random.uniform(k1, (B, N + 1))
    resample = jax.random.uniform(k2, (B, N + 1), minval=0.0,
                                  maxval=1.0 / (N + 1) - EPS)
    return tm.RenderNoise(_t(sample), _t(resample))


def _joint_noise(key):
    """The noise of one JAX joint step from its state key, and the next key."""
    key, sub = jax.random.split(key)
    return _noise(sub), key


def _reference_noise(key, prop_inner_steps=2):
    subs = []
    for _ in range(prop_inner_steps + 1):
        key, sub = jax.random.split(key)
        subs.append(_noise(sub))
    return subs, key


def _batch(seed=0):
    rays = jax_dummy_rays(B, seed=seed)
    pixels = np.random.default_rng(seed).uniform(size=(B, 3)).astype(np.float32)
    return rays, pixels


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    fn = (jstep.reference_cadence_step if jcfg.train.cadence == "reference"
          else jstep.joint_cadence_step)
    return jax.jit(functools.partial(fn, jcfg))


def _jax_state(jcfg, seed=0):
    return jax_init_state(jax.random.PRNGKey(seed), jcfg.model, jcfg.train)


def _port_state(jstate):
    return interop.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        device="cpu")


def _assert_trees_close(got_leaves, want_tree, tol, what):
    want = jax.tree.leaves(want_tree)
    assert len(got_leaves) == len(want)
    for i, (g, w) in enumerate(zip(got_leaves, want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=f"{what} leaf {i}", **tol)


# --- losses -----------------------------------------------------------------

def _weights_and_grids(seed=0, b=32, nf=16, nc=12):
    rng = np.random.default_rng(seed)
    s = np.sort(rng.uniform(0, 1, (b, nf + 1)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (b, nf)).astype(np.float32)
    w /= w.sum(-1, keepdims=True) * 1.1
    tc = np.sort(rng.uniform(0, 1, (b, nc + 1)), -1).astype(np.float32)
    wc = rng.uniform(0, 0.2, (b, nc)).astype(np.float32)
    return s, w, tc, wc


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_distortion_loss_and_grad_match_jax(reduction):
    s, w, _, _ = _weights_and_grids(1)
    want, want_g = jax.value_and_grad(jl.distortion_loss, argnums=1)(
        jnp.asarray(s), jnp.asarray(w), reduction)
    wt = _t(w).requires_grad_()
    got = tl.distortion_loss(_t(s), wt, reduction)
    (got_g,) = torch.autograd.grad(got, [wt])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-6)
    if reduction == "sum":
        quad = tl.distortion_loss_quadratic(_t(s), _t(w))
        np.testing.assert_allclose(quad.item(), got.item(), rtol=1e-5)
        np.testing.assert_allclose(
            quad.item(), float(jl.distortion_loss_quadratic(
                jnp.asarray(s), jnp.asarray(w))), rtol=1e-5)


def test_distortion_loss_rejects_unknown_reduction():
    s, w, _, _ = _weights_and_grids(2)
    with pytest.raises(ValueError, match="reduction"):
        tl.distortion_loss(_t(s), _t(w), "Mean")


def test_weight_bounds_forms_agree_with_jax():
    s, w, tc, _ = _weights_and_grids(3)
    tc[0, 3:6] = s[0, 5]                 # coarse edges touching fine edges
    want = np.asarray(jdist.weight_bounds_einsum(*map(jnp.asarray, (s, w, tc))))
    einsum = tdist.weight_bounds_einsum(_t(s), _t(w), _t(tc))
    banded = tdist.weight_bounds_banded(_t(s), _t(w), _t(tc))
    np.testing.assert_allclose(einsum.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(banded.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        banded.numpy(),
        np.asarray(jdist.weight_bounds_banded(*map(jnp.asarray, (s, w, tc)))),
        rtol=1e-6, atol=1e-7)


def _spy(picked, tag, form, real):
    def spy(*args):
        picked[tag] = form
        return real(*args)
    return spy


@pytest.mark.parametrize("data_shards", [1, 4])
def test_weight_bounds_dispatch_picks_the_same_form(monkeypatch, data_shards):
    s, w, tc, _ = _weights_and_grids(4)
    nbytes = tdist._einsum_transient_bytes(_t(w), 12, data_shards)
    assert nbytes == jdist._einsum_transient_bytes(jnp.asarray(w), 12,
                                                   data_shards)
    for threshold in (nbytes - 1, nbytes):
        monkeypatch.setattr(tdist, "_BANDED_BYTES_THRESHOLD", threshold)
        monkeypatch.setattr(jdist, "_BANDED_BYTES_THRESHOLD", threshold)
        picked = {}
        for mod, tag in ((tdist, "torch"), (jdist, "jax")):
            for form in ("weight_bounds_banded", "weight_bounds_einsum"):
                monkeypatch.setattr(mod, form, _spy(picked, tag, form,
                                                    getattr(mod, form)))
        tdist.weight_bounds(_t(s), _t(w), _t(tc), data_shards)
        jdist.weight_bounds(*map(jnp.asarray, (s, w, tc)), data_shards)
        want = ("weight_bounds_banded" if nbytes > threshold
                else "weight_bounds_einsum")
        assert picked == {"torch": want, "jax": want}
        monkeypatch.undo()


@pytest.mark.parametrize("collapsed", [False, True])
def test_distillation_loss_and_grad_match_jax(collapsed):
    s, w, tc, wc = _weights_and_grids(5)

    def j_loss(wc, w):
        return jl.distillation_loss(jnp.asarray(s), w, jnp.asarray(tc), wc,
                                    collapsed=collapsed)

    want, (want_gc, want_gf) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(wc), jnp.asarray(w))
    wct, wt = _t(wc).requires_grad_(), _t(w).requires_grad_()
    got = tl.distillation_loss(_t(s), wt, _t(tc), wct, collapsed=collapsed)
    got_gc, got_gf = torch.autograd.grad(got, [wct, wt], allow_unused=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_gc.numpy(), np.asarray(want_gc), rtol=1e-4,
                               atol=1e-5)
    # the bound carries no gradient into the NeRF level's weights
    assert got_gf is None and not np.asarray(want_gf).any()


def test_photometric_loss_and_grad_match_jax():
    rng = np.random.default_rng(6)
    pred, target = (rng.uniform(size=(B, 3)).astype(np.float32) for _ in "ab")
    (want, want_psnr), want_g = jax.value_and_grad(
        jl.photometric_loss, has_aux=True)(jnp.asarray(pred), jnp.asarray(target))
    pt = _t(pred).requires_grad_()
    got, got_psnr = tl.photometric_loss(pt, _t(target))
    (got_g,) = torch.autograd.grad(got, [pt])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_psnr.item(), float(want_psnr), rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-7)
    mse = torch.tensor(0.01)
    np.testing.assert_allclose(tl.psnr_to_mse(tl.mse_to_psnr(mse)).item(),
                               0.01, rtol=1e-6)


# --- schedule ---------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (0, 2e-3, 2e-5, 1000, 0, 1.0), (1000, 2e-3, 2e-5, 1000, 0, 1.0),
    (0, 2e-3, 2e-5, 1000, 100, 0.1), (100, 2e-3, 2e-5, 1000, 100, 0.1),
    (37, 2e-3, 2e-5, 1000, 100, 0.01), (500, 1e-2, 1e-4, 1000, 0, 1.0),
    (4000, 2e-3, 2e-5, 1500, 0, 1.0)])
def test_log_lerp_lr_matches_jax(args):
    got = log_lerp_lr(*args)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(jax_lr(*args)), rtol=1e-6)


def test_lr_max_steps_horizon_matches_jax():
    cfg = TrainConfig(max_steps=4000, lr_max_steps=1500, lr_delay_steps=0)
    jcfg = JTrainConfig(max_steps=4000, lr_max_steps=1500, lr_delay_steps=0)
    for count in [0, 750, 1500, 2000, 4000]:
        np.testing.assert_allclose(tstep._lr(cfg, count).item(),
                                   float(jstep._lr(jcfg, count)), rtol=1e-6)


# --- the train step ---------------------------------------------------------

def _jax_joint_grads(jcfg, jstate, rays, pixels):
    """``jax.grad`` of the loss inside the JAX package's joint step."""
    _, sub = jax.random.split(jstate.key)
    t = jcfg.train

    def loss_fn(params):
        t_prop, w_prop, out = jstep._forward_both(params, jcfg.model, rays,
                                                  sub, t.randomized)
        loss_nerf, _ = jl.photometric_loss(out["rgb"], pixels)
        loss_dist = jl.distortion_loss(out["s_vals"], out["weights"],
                                       t.dist_loss_reduction)
        loss_prop = jl.distillation_loss(
            jax.lax.stop_gradient(out["t_vals"]),
            jax.lax.stop_gradient(out["weights"]), t_prop, w_prop)
        return loss_nerf + t.dist_loss_weight * loss_dist + loss_prop

    return jax.jit(jax.grad(loss_fn))(jstate.params)


def test_joint_step_matches_jax_after_one_step():
    jcfg, cfg = _configs("joint")
    jstate = _jax_state(jcfg)
    rays, pixels = _batch(0)
    jrays = jax_rays_map(jnp.asarray, rays)
    want_grads = _jax_joint_grads(jcfg, jstate, jrays, jnp.asarray(pixels))
    state = _port_state(jstate)
    noise, _ = _joint_noise(jstate.key)
    grads, _ = tstep.joint_cadence_grads(cfg, state, rays_to_device(rays, "cpu"),
                                         _t(pixels), noise=noise)
    for k in ("prop", "nerf"):
        _assert_trees_close(grads[k], want_grads[k], STEP_TOL, f"grad {k}")

    jnew, jaux = _jax_step(jcfg)(jstate, jrays, jnp.asarray(pixels))
    state, aux = tstep.joint_cadence_step(cfg, state, rays_to_device(rays, "cpu"),
                                          _t(pixels), noise=noise)
    assert set(aux) == set(jaux) == {"loss", "psnr", "loss_nerf", "loss_dist",
                                     "loss_prop", "lr"}
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), err_msg=k,
                                   **STEP_TOL)
    assert (state.step, state.sched_count) == (1, 1)
    assert [state.opt_state[k].count for k in ("prop", "nerf")] == [1, 1]


@pytest.mark.parametrize("cadence", ["joint", "reference"])
def test_params_match_jax_after_three_steps(cadence):
    jcfg, cfg = _configs(cadence)
    jstate = _jax_state(jcfg, seed=1)
    state = _port_state(jstate)
    key = jstate.key
    for i in range(3):
        rays, pixels = _batch(i)
        jstate, jaux = _jax_step(jcfg)(jstate, jax_rays_map(jnp.asarray, rays),
                                       jnp.asarray(pixels))
        noise, key = (_joint_noise(key) if cadence == "joint"
                      else _reference_noise(key))
        state, aux = tstep.make_train_step(cfg)(
            state, rays_to_device(rays, "cpu"), _t(pixels), noise=noise)
        for k in aux:
            np.testing.assert_allclose(aux[k].item(), float(jaux[k]),
                                       err_msg=f"step {i} {k}", **STEP_TOL)
    assert (state.step, state.sched_count) == (int(jstate.step),
                                               int(jstate.sched_count))
    _assert_trees_close(leaves(state.params), jstate.params, PARAM_TOL, "param")
    # The first moments are averaged gradients: sums over rays taken in
    # another order, from params that already differ at PARAM_TOL, so their
    # error scales with each leaf's largest entry, not with every entry.
    for k in ("prop", "nerf"):
        adam = jstate.opt_state[k][0]
        assert state.opt_state[k].count == int(adam.count)
        for i, (g, w) in enumerate(zip(leaves(state.opt_state[k].mu),
                                       jax.tree.leaves(adam.mu))):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"mu {k} leaf {i}")


def test_reference_cadence_needs_a_prop_step():
    _, cfg = _configs("reference", prop_inner_steps=0)
    state = _port_state(_jax_state(_configs("reference")[0]))
    rays, pixels = _batch(0)
    with pytest.raises(ValueError, match="prop_inner_steps"):
        tstep.reference_cadence_step(cfg, state, rays_to_device(rays, "cpu"),
                                     _t(pixels))


def test_train_state_carried_over_from_jax_continues_alike():
    jcfg, cfg = _configs("joint")
    jstate = _jax_state(jcfg, seed=2)
    for i in range(2):
        rays, pixels = _batch(10 + i)
        jstate, _ = _jax_step(jcfg)(jstate, jax_rays_map(jnp.asarray, rays),
                                    jnp.asarray(pixels))
    state = _port_state(jstate)
    assert (state.step, state.sched_count) == (2, 2)
    assert state.opt_state["nerf"].count == 2
    _assert_trees_close(leaves(state.params), jstate.params,
                        dict(rtol=0, atol=0), "carried param")
    rays, pixels = _batch(12)
    noise, _ = _joint_noise(jstate.key)
    jstate, jaux = _jax_step(jcfg)(jstate, jax_rays_map(jnp.asarray, rays),
                                   jnp.asarray(pixels))
    state, aux = tstep.joint_cadence_step(cfg, state, rays_to_device(rays, "cpu"),
                                          _t(pixels), noise=noise)
    np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]),
                               **STEP_TOL)
    _assert_trees_close(leaves(state.params), jstate.params, PARAM_TOL, "param")


def _jax_state_from_numpy(tree, key):
    """The JAX ``TrainState`` of a :func:`interop.train_state_to_numpy_tree`
    result (the key, which the port does not carry, from the caller)."""
    arr = functools.partial(jax.tree.map, jnp.asarray)
    opt = {k: (optax.ScaleByAdamState(count=jnp.asarray(a.count),
                                      mu=arr(a.mu), nu=arr(a.nu)),
               optax.EmptyState())
           for k, (a, _) in tree.opt_state.items()}
    return JTrainState(step=jnp.asarray(tree.step),
                       sched_count=jnp.asarray(tree.sched_count),
                       params=arr(tree.params), opt_state=opt, key=key)


def test_train_state_round_trip_through_the_port_is_bit_identical():
    jcfg, _ = _configs("joint")
    jstate = _jax_state(jcfg, seed=4)
    for i in range(2):     # moments and counts away from their init
        rays, pixels = _batch(20 + i)
        jstate, _ = _jax_step(jcfg)(jstate, jax_rays_map(jnp.asarray, rays),
                                    jnp.asarray(pixels))
    tree = interop.train_state_to_numpy_tree(_port_state(jstate))
    assert tree.key is None
    back = _jax_state_from_numpy(tree, jstate.key)
    assert (jax.tree.structure(back) == jax.tree.structure(jstate))
    for path, (g, w) in zip(
            jax.tree.leaves(jax.tree_util.tree_map_with_path(
                lambda p, _: jax.tree_util.keystr(p), jstate)),
            zip(jax.tree.leaves(back), jax.tree.leaves(jstate))):
        assert np.asarray(g).dtype == np.asarray(w).dtype, path
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=path)


def test_remat_gives_the_same_gradients():
    jcfg, cfg = _configs("joint")
    state = _port_state(_jax_state(jcfg, seed=3))
    rays, pixels = _batch(3)
    noise, _ = _joint_noise(jax.random.PRNGKey(3))
    got = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                               remat=remat))
        got[remat], _ = tstep.joint_cadence_grads(
            c, state, rays_to_device(rays, "cpu"), _t(pixels), noise=noise)
    for k in ("prop", "nerf"):
        for a, b in zip(got[False][k], got[True][k]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_joint_step_bf16_matches_jax_loosely():
    """bfloat16: the two packages round hidden units differently (one bf16
    ulp, 2^-8, in places; see tests/test_torch_model.py), and the rounding of
    dX and dW to bf16 in the backward adds as much again per layer. So the
    aux losses are held at rtol 2e-2, and each gradient leaf by its
    relative L2 error at 5e-2."""
    jcfg, cfg = _configs("joint", model=dict(compute_dtype="bfloat16"))
    jstate = _jax_state(jcfg, seed=4)
    rays, pixels = _batch(4)
    jrays = jax_rays_map(jnp.asarray, rays)
    want_grads = _jax_joint_grads(jcfg, jstate, jrays, jnp.asarray(pixels))
    _, jaux = _jax_step(jcfg)(jstate, jrays, jnp.asarray(pixels))
    state = _port_state(jstate)
    noise, _ = _joint_noise(jstate.key)
    grads, aux = tstep.joint_cadence_grads(
        cfg, state, rays_to_device(rays, "cpu"), _t(pixels), noise=noise)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), err_msg=k,
                                   rtol=2e-2, atol=2e-2)
    for k in ("prop", "nerf"):
        for i, (g, w) in enumerate(zip(grads[k], jax.tree.leaves(want_grads[k]))):
            w = np.asarray(w)
            err = np.linalg.norm(g.numpy() - w) / max(np.linalg.norm(w), 1e-12)
            assert err < 5e-2, (k, i, err)
