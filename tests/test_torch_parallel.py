"""The port's parallel layer against the JAX package (counterpart of
tests/test_parallel.py and of tests/test_multihost.py's train step): the
sample-axis composite and render, the data-parallel step, and the local
batch stacks.

Multi-rank runs are gloo process groups on the CPU (``_torch_ranks.py``);
one spawn per group of checks, shared by the tests below through a
module-scoped fixture. Tolerances:
- sample-axis composite against JAX's ``volumetric_rendering``: outputs and
  weights atol 1e-5, gradients atol/rtol 1e-4 (JAX's own, and alpha is
  ``-expm1`` here against JAX's ``1 - exp``); the sample-axis render
  against the one-rank render atol 2e-5 / rtol 1e-5;
- the data-parallel step against the one-process step on the whole batch
  (float32; only summation orders differ): losses and gradients rtol 1e-4
  / atol 1e-6, params after the update rtol 2e-4 / atol 1e-6; the ranks
  against each other bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_cases import (DP_B, DP_CASES, DP_N, TP_MESHES,
                                   banded_threshold, dp_batch, dp_config,
                                   sample_axis_batch, tp_config)
from _torch_ranks import run_ranks
from mipnerf360_torch.config import Config, ModelConfig, TrainConfig
from mipnerf360_torch.core.rays import dummy_rays, rays_to_device
from mipnerf360_torch.config import DataConfig
from mipnerf360_torch.data import get_dataset
from mipnerf360_torch.losses import distillation as tdist
from mipnerf360_torch.train import init_train_state
from mipnerf360_torch.train import step as tstep
from mipnerf360_torch.train.state import leaves
from mipnerf360_tpu.core.rendering import volumetric_rendering
from mipnerf360_tpu.losses import distillation as jdist

torch.set_num_threads(1)

COMPOSITE_TOL = dict(atol=1e-5, rtol=0)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)


def _assemble(ranks, key, shards):
    """The whole array from every rank's rows, and for the per-sample
    weights and gradients, its run of samples."""
    first = ranks[0][key]
    per_sample = key.startswith(("weights", "grad"))
    out = np.zeros((16, 64) if per_sample else (16,) + first.shape[1:],
                   first.dtype)
    for r in ranks:
        rows = r[f"rows_{shards}"]
        if per_sample:
            out[np.ix_(rows, r[f"samples_{shards}"])] = r[key]
        else:
            out[rows] = r[key]
    return out


@pytest.fixture(scope="module")
def sample_axis(tmp_path_factory):
    return run_ranks("_torch_sample_axis_worker.py", 4,
                     tmp_path_factory.mktemp("sample_axis"))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_sample_axis_composite_matches_jax(sample_axis, shards, white_bkgd):
    rgb, density, t_vals, dirs = map(jnp.asarray, sample_axis_batch())
    want = volumetric_rendering(rgb, density, t_vals, dirs, white_bkgd)
    tag = f"{shards}_{int(white_bkgd)}"
    for name, w in zip(("rgb", "distance", "acc", "weights"), want):
        got = _assemble(sample_axis, f"{name}_{tag}", shards)
        np.testing.assert_allclose(got, np.asarray(w), err_msg=name,
                                   **COMPOSITE_TOL)


@pytest.mark.parametrize("shards", [2, 4])
def test_sample_axis_gradients_match_jax(sample_axis, shards):
    """The collectives are transparent to autograd: no gradient is off by
    the number of shards."""
    import jax

    rgb, density, t_vals, dirs = map(jnp.asarray, sample_axis_batch())

    def loss(d):
        r, _, a, _ = volumetric_rendering(rgb, d, t_vals, dirs, False)
        return jnp.sum(r ** 2) + jnp.sum(a)

    want = np.asarray(jax.grad(loss)(density))
    got = _assemble(sample_axis, f"grad_{shards}_0", shards)
    np.testing.assert_allclose(got, want, **GRAD_TOL)


def test_sample_axis_rejects_indivisible_sample_axis(sample_axis):
    for r in sample_axis:
        assert r["indivisible_raised_4"] == 1 and r["indivisible_raised_2"] == 1
        assert r["three_shards_raised"] == 1


@pytest.mark.parametrize("shards", [2, 4])
def test_render_image_sample_shards_matches_single_device(sample_axis, shards):
    for r in sample_axis:
        np.testing.assert_allclose(r[f"render_{shards}"], r["render_1"],
                                   atol=2e-5, rtol=1e-5)
        # a repeated render reuses its mesh's process groups
        np.testing.assert_array_equal(r[f"render_{shards}_again"],
                                      r[f"render_{shards}"])
        assert int(r["groups_after_repeats"]) == int(r["groups_after_first"])


# --- queue-3 fault 1: the train step ignores sample_shards ------------------

def test_train_step_with_sample_shards_matches_jax():
    """``model.sample_shards`` concerns the render only, as in the JAX
    package: one train step with it set runs in one process and matches
    JAX's step."""
    import jax

    from mipnerf360_tpu.config import Config as JConfig
    from mipnerf360_tpu.config import ModelConfig as JModelConfig
    from mipnerf360_tpu.config import TrainConfig as JTrainConfig
    from mipnerf360_tpu.core.rays import rays_map as jax_rays_map
    from mipnerf360_tpu.train import step as jstep
    from mipnerf360_tpu.train.state import init_train_state as jax_init_state
    from mipnerf360_torch import interop
    from mipnerf360_torch.models.mipnerf360 import RenderNoise

    b, n = 32, 16
    m = dict(num_samples=n, hidden_proposal=16, hidden_nerf=32, nerf_depth=2,
             compute_dtype="float32", use_pallas="off", sample_shards=2)
    t = dict(batch_size=b, max_steps=100, lr_delay_steps=5)
    jcfg = JConfig(model=JModelConfig(**m), train=JTrainConfig(**t))
    cfg = Config(model=ModelConfig(**m), train=TrainConfig(**t))
    jstate = jax_init_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train)
    state = interop.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         device="cpu")
    rays = dummy_rays(b, seed=3)
    pixels = np.random.default_rng(3).uniform(size=(b, 3)).astype(np.float32)
    _, sub = jax.random.split(jstate.key)
    k1, k2 = jax.random.split(sub)
    eps = np.finfo(np.float32).eps
    noise = RenderNoise(
        torch.tensor(np.asarray(jax.random.uniform(k1, (b, n + 1)))),
        torch.tensor(np.asarray(jax.random.uniform(
            k2, (b, n + 1), minval=0.0, maxval=1.0 / (n + 1) - eps))))
    jnew, jaux = jax.jit(lambda s, r, p: jstep.joint_cadence_step(jcfg, s, r, p))(
        jstate, jax_rays_map(jnp.asarray, rays), jnp.asarray(pixels))
    state, aux = tstep.joint_cadence_step(cfg, state, rays_to_device(rays, "cpu"),
                                          torch.from_numpy(pixels), noise=noise)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), err_msg=k,
                                   **STEP_TOL)
    for g, w in zip(leaves(state.params), jax.tree.leaves(jnew.params)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   **PARAM_TOL)


# --- the local batch stacks (one process) -----------------------------------

@pytest.mark.parametrize("ranks", [2, 4])
def test_local_stacks_concatenate_to_the_global_stacks(ranks):
    """Each rank's staging (the ``*_local`` stacks) is its rows of the
    global stacks bit for bit (the JAX package's staging-parity worker):
    rank r's columns [r*B/P, (r+1)*B/P) of each [K, B, c] stack (no process
    group is needed to cut rows)."""
    ds = get_dataset(DataConfig(dataset="synthetic", synthetic_resolution=8,
                                synthetic_views=2), "train")
    k, batch, seed, start = 3, 16, 5, 7
    rays, pix = ds.batch_stack(k, batch, seed, start)
    idx = ds.index_stack(k, batch, seed, start)
    per = batch // ranks
    for r in range(ranks):
        cols = slice(r * per, (r + 1) * per)
        got_rays, got_pix = ds.batch_stack_local(k, batch, seed, start, r,
                                                 ranks)
        for a, b in zip(tuple(got_rays) + (got_pix,), tuple(rays) + (pix,)):
            np.testing.assert_array_equal(a, b[:, cols])
        np.testing.assert_array_equal(
            ds.index_stack_local(k, batch, seed, start, r, ranks),
            idx[:, cols])
    with pytest.raises(ValueError, match="does not split"):
        ds.index_stack_local(k, 18, seed, start, 0, 4)


# --- the data-parallel step (2 and 4 ranks) ----------------------------------

@pytest.fixture(scope="module", params=[2, 4])
def data_parallel(request, tmp_path_factory):
    nproc = request.param
    return nproc, run_ranks("_torch_dp_worker.py", nproc,
                            tmp_path_factory.mktemp(f"dp{nproc}"),
                            banded_threshold(nproc))


def _one_process(train):
    """The port's one-process step on the whole batch: (grads, aux, params
    after the step)."""
    cfg = dp_config(**train)
    rays, pixels = dp_batch()
    rays, pixels = rays_to_device(rays, "cpu"), torch.from_numpy(pixels)
    state = init_train_state(cfg.model, cfg.train, device="cpu")
    grads = None
    if cfg.train.cadence == "joint":
        probe = init_train_state(cfg.model, cfg.train, device="cpu")
        g, _ = tstep.joint_cadence_grads(cfg, probe, rays, pixels)
        grads = g["prop"] + g["nerf"]
    state, aux = tstep.make_train_step(cfg)(state, rays, pixels)
    return grads, aux, leaves(state.params)


@pytest.mark.parametrize("name,train", DP_CASES)
def test_data_parallel_step_matches_one_process(data_parallel, name, train,
                                                monkeypatch):
    nproc, ranks = data_parallel
    r0 = ranks[0]
    assert int(r0["mesh_data"]) == nproc, "mesh.data=-1 is the world size"
    keys = [k for k in r0 if k.startswith(f"{name}_")]
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], r0[k], err_msg=k)
    if name == "banded":
        monkeypatch.setattr(tdist, "_BANDED_BYTES_THRESHOLD",
                            banded_threshold(nproc))
    grads, aux, params = _one_process(train)
    for k, v in aux.items():
        np.testing.assert_allclose(r0[f"{name}_aux_{k}"], v.item(), err_msg=k,
                                   **STEP_TOL)
    if grads is not None:
        for i, g in enumerate(grads):
            np.testing.assert_allclose(r0[f"{name}_grad_{i}"], g.numpy(),
                                       err_msg=f"grad {i}", **STEP_TOL)
    for i, p in enumerate(params):
        np.testing.assert_allclose(r0[f"{name}_param_{i}"],
                                   p.detach().numpy(), err_msg=f"param {i}",
                                   **PARAM_TOL)


def test_data_parallel_bounds_dispatch_picks_the_form_jax_picks(
        data_parallel, monkeypatch):
    """A rank holds [B/P, N] of the weights and passes data_shards=1; JAX
    holds [B, N] and passes the data axis: at the same threshold both pick
    the banded form (and the einsum one a byte higher)."""
    nproc, ranks = data_parallel
    low = banded_threshold(nproc)
    picked = {}
    w = jnp.zeros((DP_B, DP_N), jnp.float32)
    for threshold in (low, low + 1):
        monkeypatch.setattr(jdist, "_BANDED_BYTES_THRESHOLD", threshold)
        banded = jdist._einsum_transient_bytes(w, DP_N, nproc) > threshold
        picked[threshold] = "banded" if banded else "einsum"
    assert picked == {low: "banded", low + 1: "einsum"}
    for r in ranks:
        assert str(r["banded_form"]) == "banded"
        assert str(r["joint_form"]) == "einsum"


def test_collectives_backward_rules(data_parallel):
    """global_sum passes its cotangent through; a gather with sum_backward
    gives each slot the sum of every rank's cotangent, one without keeps
    the rank's own: no stray factor of the world size."""
    nproc, ranks = data_parallel
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["global_sum_grad"], [3.0])
        # rank j's loss is (j + 1) times the gathered sum
        np.testing.assert_array_equal(r["gather_sum_grad"],
                                      [nproc * (nproc + 1) / 2])
        np.testing.assert_array_equal(r["gather_own_grad"], [rank + 1.0])


# --- tensor parallelism of the NeRF trunk (2 and 4 ranks) --------------------

@pytest.fixture(scope="module", params=sorted(TP_MESHES))
def tensor_parallel(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"tp{request.param}")
    return request.param, root / "ckpt", run_ranks(
        "_torch_tp_worker.py", request.param, root, root / "ckpt")


def test_tensor_parallel_step_matches_one_process(tensor_parallel):
    nproc, _, ranks = tensor_parallel
    data, model, depth = TP_MESHES[nproc]
    cfg = tp_config(depth)
    rays, pixels = dp_batch()
    rays, pixels = rays_to_device(rays, "cpu"), torch.from_numpy(pixels)
    probe = init_train_state(cfg.model, cfg.train, device="cpu")
    g, _ = tstep.joint_cadence_grads(cfg, probe, rays, pixels)
    state = init_train_state(cfg.model, cfg.train, device="cpu")
    state, aux = tstep.make_train_step(cfg)(state, rays, pixels)
    for r in ranks:
        for i, want in enumerate(g["prop"] + g["nerf"]):
            np.testing.assert_allclose(r[f"grad_{i}"], want.numpy(),
                                       err_msg=f"grad {i}", **STEP_TOL)
        for k, v in aux.items():
            np.testing.assert_allclose(r[f"aux_{k}"], v.item(), err_msg=k,
                                       **STEP_TOL)
        for i, p in enumerate(leaves(state.params)):
            np.testing.assert_allclose(r[f"param_{i}"], p.detach().numpy(),
                                       err_msg=f"param {i}", **PARAM_TOL)
        for i, mu in enumerate(leaves(state.opt_state["nerf"].mu)):
            mu = mu.numpy()
            np.testing.assert_allclose(r[f"mu_{i}"], mu, rtol=2e-4,
                                       atol=1e-4 * np.abs(mu).max())


def test_tensor_parallel_bf16_gradients_match_one_process(tensor_parallel):
    """bfloat16: each shard rounds its own GEMM outputs, so gradient leaves
    are held by relative L2 error at 5e-2, as the one-process bf16 step is
    held to JAX (tests/test_torch_train.py)."""
    nproc, _, ranks = tensor_parallel
    cfg = tp_config(TP_MESHES[nproc][2])
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))
    rays, pixels = dp_batch()
    g, _ = tstep.joint_cadence_grads(
        cfg, init_train_state(cfg.model, cfg.train, device="cpu"),
        rays_to_device(rays, "cpu"), torch.from_numpy(pixels))
    for i, want in enumerate(g["prop"] + g["nerf"]):
        want = want.numpy()
        err = (np.linalg.norm(ranks[0][f"bf16_grad_{i}"] - want)
               / max(np.linalg.norm(want), 1e-12))
        assert err < 5e-2, (i, err)


def test_tensor_parallel_ranks_agree(tensor_parallel):
    """Every rank gathers the same full state, and the ranks of a model
    group hold bit-identical copies of every leaf that is not split."""
    nproc, _, ranks = tensor_parallel
    keys = [k for k in ranks[0] if k.startswith(("param_", "aux_", "grad_"))]
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    local = sorted(k for k in ranks[0] if k.startswith("local_param_"))
    for a in ranks:
        for b in ranks:
            if a["data_index"] == b["data_index"]:
                same = [k for k in local if a[k].shape == b[k].shape
                        and a[k].shape == ranks[0][k.replace("local_", "")].shape]
                assert same
                for k in same:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tensor_parallel_render_and_eval_match_one_rank(tensor_parallel):
    from mipnerf360_torch.models import mipnerf360 as tm
    from mipnerf360_torch.train.trainer import evaluate_batch

    nproc, ckpt, ranks = tensor_parallel
    cfg = tp_config(TP_MESHES[nproc][2])
    params = {k: v for k, v in torch.load(
        next(ckpt.glob("ckpt_1.pt")), weights_only=True)["params"].items()}
    rgb, dist, acc = tm.render_image(params, cfg.model, dummy_rays(40),
                                     chunk=16, device="cpu")
    psnr = evaluate_batch(cfg, params, *dp_batch(), device="cpu")
    for r in ranks:
        for k, want in (("rgb", rgb), ("distance", dist), ("acc", acc)):
            np.testing.assert_allclose(r[f"render_{k}"], want.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(r["eval_psnr"], psnr, rtol=1e-5)


def test_tensor_parallel_checkpoint_loads_in_jax(tensor_parallel):
    """Rank 0 writes the gathered tree: its params, through interop, are a
    JAX params tree that renders as the port does."""
    import jax

    from mipnerf360_tpu.config import ModelConfig as JModelConfig
    from mipnerf360_tpu.core.rays import rays_map as jax_rays_map
    from mipnerf360_tpu.models.mipnerf360 import render_rays as jax_render_rays
    from mipnerf360_torch import interop
    from mipnerf360_torch.models import mipnerf360 as tm

    nproc, ckpt, ranks = tensor_parallel
    cfg = tp_config(TP_MESHES[nproc][2])
    sd = torch.load(ckpt / "ckpt_1.pt", weights_only=True)
    assert sd["step"] == 1
    params_np = interop.params_to_numpy(sd["params"])
    for i, p in enumerate(jax.tree.leaves(params_np)):
        np.testing.assert_array_equal(p, ranks[0][f"param_{i}"])
    rays = dummy_rays(24)
    jcfg = JModelConfig(**{f: getattr(cfg.model, f) for f in
                           ("num_samples", "hidden_proposal", "hidden_nerf",
                            "nerf_depth", "compute_dtype")},
                        use_pallas="off")
    want = jax_render_rays(jax.tree.map(jnp.asarray, params_np), jcfg,
                           jax_rays_map(jnp.asarray, rays),
                           jax.random.PRNGKey(0), randomized=False)
    got = tm.render_rays(interop.params_from_jax(params_np), cfg.model,
                         rays_to_device(rays, "cpu"), randomized=False)
    for k in ("rgb", "distance", "acc"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)
