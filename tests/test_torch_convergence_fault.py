"""The spike regime of the proposal-distillation loss, on the card's own rays.

``tests/data/convergence_spike_seed0.npz`` holds the 64 rays of the largest
hinge at steps 2,144 and 2,145 of ``parity_psnr --mode convergence``, seed 0,
on an NVIDIA H100 (``python tests/_spike_replay.py --seed 0 --start
2140``; its ``fixture_2144.npz`` and ``fixture_2145.npz`` stacked on a
leading step axis). Step 2,144's update broke the run; step 2,145 is the
spike itself: proposal weights down to 5e-23 under NeRF bounds near 1,
and cotangents of the hinge's sum over samples up to -7e11. Each step holds
the rays, pixels and noise, both levels' t_vals, densities and weights (the
weights as K1 computed them on the card), the bound and ``dirs``.

On these inputs the port's plain versions are held against the JAX package,
through ``use_pallas="on"`` (its TPU kernel in interpret mode, as its own
tests run it) and ``"off"`` (jnp autodiff):

- the composite forward, both levels, and the card's K1 output against the
  plain version: rtol 1e-5 / atol 1e-6 (the JAX package's Pallas-vs-core
  tolerance);
- the hinge and its gradient in the proposal weights: the loss at rtol
  1e-5, the gradient within 1e-5 of each ray's largest |g|;
- the gradient in the proposal density through the composite and the
  hinge, and the plain K2 against autograd of the plain K1 with the hinge's
  cotangent: within 1e-4 of each ray's largest |d_density| (K2's tolerance,
  taken relative to the row, since entries span 20 orders of magnitude).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mipnerf360_tpu.losses.distillation import \
    distillation_loss as jax_distillation
from mipnerf360_tpu.ops import fused as jfused
from mipnerf360_torch.losses.distillation import distillation_loss
from mipnerf360_torch.ops import composite

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "data" / "convergence_spike_seed0.npz"
STEPS = (2144, 2145)
MODES = ("on", "off")
K1_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-5
HINGE_GRAD_ROW_TOL = 1e-5
DENSITY_GRAD_ROW_TOL = 1e-4


def _step(step: int) -> dict:
    z = np.load(FIXTURE)
    i = list(z["steps"]).index(step)
    return {n: z[n][i] for n in z.files if n != "steps"}


def _t(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


def _jax_weights(density, t_vals, dirs, mode):
    with pltpu.force_tpu_interpret_mode():
        return jfused.compute_alpha_weights(density, jnp.asarray(t_vals),
                                            jnp.asarray(dirs), mode=mode)


def _hinge_cotangent(f):
    """d loss / d w_prop of the port's hinge at the fixture's weights."""
    w = _t(f["w_prop"], grad=True)
    loss = distillation_loss(_t(f["t_nerf"]), _t(f["w_nerf"]), _t(f["t_prop"]),
                             w)
    return torch.autograd.grad(loss, w)[0]


def _assert_rows_close(got, want, row_tol, what):
    """|got - want| within ``row_tol`` of each row's largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max(-1, keepdims=True)
    err = (np.abs(got - want) / np.where(scale > 0, scale, 1.0)).max()
    assert np.isfinite(got).all(), what
    assert err <= row_tol, f"{what}: {err:.3e} of the row's largest value"


# What each step holds: the largest |d hinge sum / d w_prop|, the least
# w_prop, and whether some w_prop < 1e-4 lies under a bound above it by 0.5.
REGIME = {2144: (1e7, 1e-17, False), 2145: (1e11, 1e-22, True)}


@pytest.mark.parametrize("step", STEPS)
def test_fixture_holds_the_spike_regime(step):
    f = _step(step)
    assert f["density_prop"].shape == (64, 64)
    assert f["t_prop"].shape == f["t_nerf"].shape == (64, 65)
    g = _hinge_cotangent(f) * f["w_prop"].shape[0]   # of the sum, not mean
    g_min, w_max, under = REGIME[step]
    assert float(g.abs().max()) > g_min
    assert f["w_prop"].min() < w_max
    assert ((f["bound"] - f["w_prop"] > 0.5)
            & (f["w_prop"] < 1e-4)).any() == under


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("level", ("prop", "nerf"))
@pytest.mark.parametrize("step", STEPS)
def test_composite_forward_matches_jax(step, level, mode):
    f = _step(step)
    args = (f[f"density_{level}"], f[f"t_{level}"], f["dirs"])
    got = composite.plain_composite_weights(*map(_t, args)).numpy()
    want = np.asarray(_jax_weights(jnp.asarray(args[0]), *args[1:], mode))
    np.testing.assert_allclose(got, want, **K1_TOL)
    # and the card's K1 result, recorded with the fixture
    np.testing.assert_allclose(f[f"w_{level}"], got, **K1_TOL)


@pytest.mark.parametrize("step", STEPS)
def test_hinge_and_its_gradient_match_jax(step):
    f = _step(step)
    w = _t(f["w_prop"], grad=True)
    loss = distillation_loss(_t(f["t_nerf"]), _t(f["w_nerf"]), _t(f["t_prop"]),
                             w)
    g = torch.autograd.grad(loss, w)[0]
    j_loss, j_g = jax.value_and_grad(
        lambda w: jax_distillation(jnp.asarray(f["t_nerf"]),
                                   jnp.asarray(f["w_nerf"]),
                                   jnp.asarray(f["t_prop"]), w))(
        jnp.asarray(f["w_prop"]))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=LOSS_RTOL)
    _assert_rows_close(g.numpy(), j_g, HINGE_GRAD_ROW_TOL, "hinge gradient")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("step", STEPS)
def test_density_gradient_through_composite_and_hinge_matches_jax(step, mode):
    f = _step(step)
    density = _t(f["density_prop"], grad=True)
    w = composite.plain_composite_weights(density, _t(f["t_prop"]),
                                          _t(f["dirs"]))
    loss = distillation_loss(_t(f["t_nerf"]), _t(f["w_nerf"]), _t(f["t_prop"]),
                             w)
    g = torch.autograd.grad(loss, density)[0]

    def j_loss(d):
        w = _jax_weights(d, f["t_prop"], f["dirs"], mode)
        return jax_distillation(jnp.asarray(f["t_nerf"]),
                                jnp.asarray(f["w_nerf"]),
                                jnp.asarray(f["t_prop"]), w)

    with pltpu.force_tpu_interpret_mode():
        want_loss, want = jax.value_and_grad(j_loss)(
            jnp.asarray(f["density_prop"]))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    _assert_rows_close(g.numpy(), want, DENSITY_GRAD_ROW_TOL,
                       f"d_density (use_pallas={mode})")


@pytest.mark.parametrize("level", ("prop", "nerf"))
@pytest.mark.parametrize("step", STEPS)
def test_plain_k2_matches_autograd_under_the_hinge_cotangent(step, level):
    f = _step(step)
    g = _hinge_cotangent(f)
    density = _t(f[f"density_{level}"], grad=True)
    t_vals, dirs = _t(f[f"t_{level}"]), _t(f["dirs"])
    w = composite.plain_composite_weights(density, t_vals, dirs)
    want = torch.autograd.grad(w, density, g)[0]
    got = composite.plain_composite_weights_bwd(density.detach(), t_vals,
                                                dirs, g)
    _assert_rows_close(got.numpy(), want.numpy(), DENSITY_GRAD_ROW_TOL,
                       "plain K2")


@pytest.mark.parametrize("mode", MODES)
def test_jax_scores_the_spike_as_the_port_does(mode):
    """Step 2,144 -> 2,145 on each step's fixture rays: the JAX package's
    hinge, from the card's proposal densities through its composite, equals
    the port's at both steps and jumps by more than four orders of
    magnitude. Both packages score the card's states alike; that the JAX
    package's own step from the state before 2,144 reaches the spike is the
    JAX half of the replay (``tests/_spike_replay_jax.py --full``)."""
    losses = {}
    for step in STEPS:
        f = _step(step)
        w = _jax_weights(jnp.asarray(f["density_prop"]), f["t_prop"],
                         f["dirs"], mode)
        want = float(jax_distillation(jnp.asarray(f["t_nerf"]),
                                      jnp.asarray(f["w_nerf"]),
                                      jnp.asarray(f["t_prop"]), w))
        got = float(distillation_loss(
            _t(f["t_nerf"]), _t(f["w_nerf"]), _t(f["t_prop"]),
            composite.plain_composite_weights(_t(f["density_prop"]),
                                              _t(f["t_prop"]),
                                              _t(f["dirs"]))))
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        losses[step] = want
    assert losses[2145] > 1e4 * losses[2144]
