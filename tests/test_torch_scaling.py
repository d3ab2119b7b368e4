"""The port's scaling harness (``mipnerf360_torch/tools/scaling.py`` and its
worker ``_scaling_worker.py``) on the CPU.

- The tool at a tiny batch over worlds 1 and 2 (gloo ranks, processes of
  their own): the JAX file's keys, one row per world, and world 2's K
  losses against world 1's. Both start from the same state and generator
  seed, and each rank draws the noise of the global batch and keeps its
  rows (``train/step.py``), so they differ only in the order of the
  sums over the batch: rtol 1e-5.
- The worker's body at world 1 (a gloo group of one in this process) from
  a state converted from the JAX package's, on the worker's batch, with
  the noise the JAX step draws passed to it: its first two steps against
  the JAX package's ``joint_cadence_step`` at STEP_TOL (rtol 1e-4 / atol
  1e-6, ``tests/test_torch_train.py``). The JAX side runs its jnp path
  (``use_pallas="off"``), as its own tests do on the CPU.
- Which backend each world takes on the card, and the refusals.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mipnerf360_torch import interop
from mipnerf360_torch.models.mipnerf360 import RenderNoise
from mipnerf360_torch.parallel import init_distributed, make_mesh, shutdown
from mipnerf360_torch.tools import _scaling_worker as worker
from mipnerf360_torch.tools import scaling
from mipnerf360_tpu.config import Config as JConfig
from mipnerf360_tpu.config import ModelConfig as JModelConfig
from mipnerf360_tpu.config import TrainConfig as JTrainConfig
from mipnerf360_tpu.core.rays import Rays as JRays
from mipnerf360_tpu.train import step as jstep
from mipnerf360_tpu.train.state import init_train_state as jax_init_state

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5
EPS = np.finfo(np.float32).eps
# The worker's model at a small size (its widths are 32 samples, 64, 256x4).
SMALL = dict(num_samples=8, hidden_proposal=16, hidden_nerf=32, nerf_depth=2,
             compute_dtype="float32", use_pallas="off")
B, K = 32, 2
JAX_FILE_KEYS = {"what", "headline", "host", "config", "virtual_mesh_rows",
                 "loopback_process_overhead"}
JAX_ROW_KEYS = {"global_devices", "steps_per_sec", "steps_per_sec_std",
                "steps_per_sec_reps", "rays_per_sec"}


@pytest.fixture(scope="module")
def tool_run(tmp_path_factory):
    """``python -m mipnerf360_torch.tools.scaling --device cpu --ranks 1,2
    --batch 64 --steps 2 --reps 1``, once for the module."""
    out = tmp_path_factory.mktemp("scaling") / "SCALING_TORCH.json"
    path = [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
    res = subprocess.run(
        [sys.executable, "-m", "mipnerf360_torch.tools.scaling", "--device",
         "cpu", "--ranks", "1,2", "--batch", "64", "--steps", "2", "--reps",
         "1", "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    return json.loads(out.read_text())


def test_tool_writes_the_jax_files_keys_and_a_row_per_world(tool_run):
    assert set(tool_run) == JAX_FILE_KEYS | {"card"}
    assert tool_run["card"] == "cpu"
    rows = tool_run["virtual_mesh_rows"]["rows"]
    assert [r["global_devices"] for r in rows] == [1, 2]
    for r in rows:
        assert JAX_ROW_KEYS <= set(r)
        assert r["card"] == "cpu" and r["backend"] == "gloo"
        assert not r["cards_shared"]
        assert len(r["steps_per_sec_reps"]) == 1 and r["steps_per_sec"] > 0
        # both are the same mean, rounded on their own: to 0.1 rays/s and
        # to 0.001 steps/s (64 x 0.0005 rays/s)
        assert r["rays_per_sec"] == pytest.approx(r["steps_per_sec"] * 64,
                                                  abs=0.05 + 64 * 0.0005)
        # the CPU takes the composite's plain version: no kernel launch
        assert r["launches"] == {"composite_fwd": 0, "composite_bwd": 0}
    # max(1, cores // world) threads per rank
    cores = os.cpu_count() or 1
    assert [r["threads"] for r in rows] == [cores, max(1, cores // 2)]
    assert tool_run["host"] == {"physical_cores": cores}
    assert rows[0]["throughput_ratio_vs_1"] == 1.0
    loop = tool_run["loopback_process_overhead"]
    assert loop["one_process"] == rows[0] and loop["two_process"] == rows[1]
    eff = loop["efficiency_2proc_vs_1proc"]
    assert eff == tool_run["headline"]["efficiency_2proc_vs_1proc"]
    assert eff == pytest.approx(rows[1]["steps_per_sec"]
                                / rows[0]["steps_per_sec"], abs=1e-4)
    assert tool_run["config"]["batch_total"] == 64


def test_world_2_losses_match_world_1(tool_run):
    one, two = tool_run["virtual_mesh_rows"]["rows"]
    for key in ("first_losses", "losses"):
        assert len(one[key]) == len(two[key]) == 2
        assert np.isfinite(one[key]).all()
        np.testing.assert_allclose(two[key], one[key], rtol=LOSS_RTOL, atol=0,
                                   err_msg=key)
    # the state advanced between the first call and the last
    assert one["first_losses"] != one["losses"]


def test_rank_threads_keep_the_total():
    assert [scaling.rank_threads("cpu", w, cores=8) for w in (1, 2, 4, 8, 16)
            ] == [8, 4, 2, 1, 1]
    assert scaling.rank_threads("cuda", 2, cores=8) == 0


def test_a_failed_rank_is_reported_with_its_log(tmp_path):
    """A batch that does not split over the ranks: the world stops at once
    and the error carries the failed rank's log."""
    args = scaling.parse_args(["--device", "cpu", "--batch", "3", "--steps",
                               "1", "--reps", "1"])
    with pytest.raises(SystemExit, match=r"(?s)rank \d exited 1.*does not "
                                         r"split"):
        scaling.run_world(2, args, "gloo", tmp_path)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _joint_noise(key, b, n):
    """The uniforms of one JAX joint step from its state key, and the next
    key (``joint_cadence_step`` splits ``state.key`` once per step)."""
    key, sub = jax.random.split(key)
    k1, k2 = jax.random.split(sub)
    sample = jax.random.uniform(k1, (b, n + 1))
    resample = jax.random.uniform(k2, (b, n + 1), minval=0.0,
                                  maxval=1.0 / (n + 1) - EPS)
    return RenderNoise(_t(sample), _t(resample)), key


def test_worker_steps_match_jax(tmp_path):
    jcfg = JConfig(model=JModelConfig(**SMALL),
                   train=JTrainConfig(batch_size=B, cadence="joint"))
    cfg = worker.worker_config(B, 1, model=SMALL)
    assert (cfg.train.batch_size, cfg.train.cadence) == (B, "joint")
    assert (cfg.mesh.data, cfg.mesh.model) == (1, 1)
    jstate = jax_init_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train)
    rays_np, pixels_np = worker.global_batch(B, K)

    noise, key = [], jstate.key
    for _ in range(K):
        n, key = _joint_noise(key, B, SMALL["num_samples"])
        noise.append(n)
    want, js = [], jstate
    step = jax.jit(lambda s, r, p: jstep.joint_cadence_step(jcfg, s, r, p))
    for i in range(K):
        js, aux = step(js, JRays(*(x[i] for x in rays_np)), pixels_np[i])
        want.append(jax.tree.map(np.asarray, aux))

    state = interop.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         device="cpu")
    init_distributed("cpu", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                     world_size=1)
    try:
        mesh = make_mesh(1, 1, device="cpu")
        rays, pixels = worker.rank_rows(mesh, rays_np, pixels_np, "cpu")
        got = worker.run_worker(cfg, state, rays, pixels, mesh, reps=1,
                                noise=noise)
    finally:
        shutdown()
    aux = got["first_aux"]
    assert set(want[0]) <= set(aux)
    for i in range(K):
        for name, value in want[i].items():
            np.testing.assert_allclose(aux[name][i].numpy(), value,
                                       err_msg=f"step {i} {name}", **STEP_TOL)
    assert len(got["steps_per_sec_reps"]) == 1
    assert got["launches"] == {"composite_fwd": 0, "composite_bwd": 0}
    # the loop ran WARMUP_CALLS + 1 calls of K steps, the state in place
    assert got["state"].step == (worker.WARMUP_CALLS + 1) * K


def test_global_batch_is_the_jax_workers():
    """``dummy_rays(batch)`` for every step, pixels from default_rng(0)."""
    from mipnerf360_tpu.core.rays import dummy_rays as jax_dummy_rays

    rays, pixels = worker.global_batch(B, K)
    want = jax_dummy_rays(B)
    for got, w in zip(rays, want):
        assert got.shape == (K,) + np.asarray(w).shape
        for i in range(K):
            np.testing.assert_array_equal(got[i], np.asarray(w))
    np.testing.assert_array_equal(
        pixels, np.random.default_rng(0).uniform(0, 1, (K, B, 3)
                                                 ).astype(np.float32))
    assert worker.WORKER_MODEL == dict(num_samples=32, hidden_proposal=64,
                                       hidden_nerf=256, nerf_depth=4,
                                       compute_dtype="float32")


def test_rank_rows_split_the_global_batch():
    """Rank r keeps rows [r*B/P, (r+1)*B/P) of each step's batch."""
    from types import SimpleNamespace

    rays, pixels = worker.global_batch(B, K)
    parts = [worker.rank_rows(SimpleNamespace(data=4, data_index=r), rays,
                              pixels, "cpu") for r in range(4)]
    np.testing.assert_array_equal(
        torch.cat([p[1] for p in parts], 1).numpy(), pixels)
    np.testing.assert_array_equal(
        torch.cat([p[0].origins for p in parts], 1).numpy(), rays.origins)
    with pytest.raises(ValueError, match="does not split"):
        worker.rank_rows(SimpleNamespace(data=3, data_index=0), rays, pixels,
                         "cpu")


def test_backend_per_world(monkeypatch):
    """On the card: NCCL with one card per rank while the cards suffice,
    else gloo ranks sharing them, marked so; a worker asked for NCCL on too
    few cards raises rather than switch to gloo."""
    assert scaling.world_backend("cpu", 4) == ("gloo", False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert scaling.world_backend("cuda", 1) == ("nccl", False)
    assert scaling.world_backend("cuda", 2) == ("nccl", False)
    assert scaling.world_backend("cuda", 4) == ("gloo", True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert worker.worker_device("cuda", "gloo", 3, 4) == torch.device("cuda", 1)
    assert worker.worker_device("cuda", "nccl", 1, 2) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="4 NCCL ranks need 4 cards"):
        worker.worker_device("cuda", "nccl", 0, 4)


def test_tool_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        scaling.main(["--out", str(tmp_path / "s.json")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        worker.worker_device("cuda", "nccl", 0, 1)
    assert not (tmp_path / "s.json").exists()


def test_efficiency_and_its_band():
    one = {"steps_per_sec": 10.0, "steps_per_sec_reps": [9.0, 11.0]}
    two = {"steps_per_sec": 8.0, "steps_per_sec_reps": [7.0, 9.0]}
    eff, band = scaling.efficiency(one, two)
    assert eff == 0.8 and band == [round(7 / 11, 4), 1.0]
    with pytest.raises(SystemExit, match="must include 1"):
        scaling.measure(scaling.parse_args(["--device", "cpu", "--ranks",
                                            "2,4"]))
