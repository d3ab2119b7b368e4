"""The port's train loops and trainer (``mipnerf360_torch/train/step.py``
loops, ``train/trainer.py``) on the CPU, against themselves and against the
JAX package's trainer.

- ``make_train_loop`` equals K sequential steps exactly, and the banked loop
  equals the host loop exactly.
- Both trainers resume from one JAX step-2 checkpoint (``randomized=false``,
  so no noise is drawn) to step 6 on the same stateless batches: params and
  moments agree at tests/test_torch_train.py's tolerances, each logged
  ``train/loss`` at rtol 1e-4.
- The port's own resume is exact with ``randomized=true``: the generator's
  state is in the checkpoint.
"""
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from mipnerf360_torch.apps import train as train_app
from mipnerf360_torch.config import Config, DataConfig, MeshConfig, ModelConfig
from mipnerf360_torch.config import TrainConfig
from mipnerf360_torch.data import get_dataset
from mipnerf360_torch.train import trainer as tr
from mipnerf360_torch.train.checkpoint import latest_checkpoint_step
from mipnerf360_torch.train.state import init_train_state, leaves
from mipnerf360_torch.train.step import (make_banked_train_loop,
                                         make_train_loop, make_train_step)
from mipnerf360_torch.core.rays import rays_map, rays_to_device
from mipnerf360_torch.utils import checks
from mipnerf360_tpu.apps import train as jax_train_app
from mipnerf360_tpu.config import Config as JConfig
from mipnerf360_tpu.train.checkpoint import restore_checkpoint as jax_restore
from mipnerf360_tpu.train.state import init_train_state as jax_init_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS = ["model.num_samples=8", "model.hidden_proposal=16",
        "model.hidden_nerf=16", "model.nerf_depth=2",
        "model.compute_dtype=float32", "data.dataset=synthetic",
        "data.synthetic_resolution=8", "data.synthetic_views=2"]
# tests/test_torch_train.py's tolerances
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)


def _argv(sets, *flags):
    return [a for s in sets for a in ("--set", s)] + list(flags)


def tiny_config(**train) -> Config:
    t = dict(max_steps=6, batch_size=16, log_every=3, save_every=0,
             eval_every=0, lr_delay_steps=0, checkpoint_dir="")
    t.update(train)
    return Config(
        model=ModelConfig(num_samples=8, hidden_proposal=16, hidden_nerf=16,
                          nerf_depth=2, compute_dtype="float32"),
        train=TrainConfig(**t),
        data=DataConfig(dataset="synthetic", synthetic_resolution=8,
                        synthetic_views=2),
        mesh=MeshConfig(data=1, model=1))


def _state(cfg):
    return init_train_state(cfg.model, cfg.train, device="cpu")


def _assert_states_equal(a, b):
    assert (a.step, a.sched_count) == (b.step, b.sched_count)
    pairs = list(zip(leaves(a.params), leaves(b.params)))
    for k in ("prop", "nerf"):
        sa, sb = a.opt_state[k], b.opt_state[k]
        assert sa.count == sb.count
        pairs += zip(leaves(sa.mu) + leaves(sa.nu), leaves(sb.mu) + leaves(sb.nu))
    for x, y in pairs:
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _losses(ckpt_dir):
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["train/loss"] for r in recs if "train/loss" in r}


# --- the loops --------------------------------------------------------------

@pytest.mark.parametrize("cadence", ["joint", "reference"])
def test_train_loop_equals_sequential_steps(cadence):
    cfg = tiny_config(cadence=cadence)
    ds = get_dataset(cfg.data, "train")
    rays, pixels = ds.batch_stack(3, 16, seed=0, start_step=0)
    rays, pixels = rays_to_device(rays, "cpu"), torch.as_tensor(pixels)
    seq, looped = _state(cfg), _state(cfg)
    step = make_train_step(cfg)
    want = []
    for i in range(3):
        seq, aux = step(seq, rays_map(lambda x: x[i], rays), pixels[i])
        want.append(aux)
    looped, aux = make_train_loop(cfg)(looped, rays, pixels)
    _assert_states_equal(looped, seq)
    assert set(aux) == set(want[0])
    for k, v in aux.items():
        assert v.shape == (3,)
        torch.testing.assert_close(v, torch.stack([a[k] for a in want]),
                                   rtol=0, atol=0)


def test_banked_loop_equals_host_loop():
    cfg = tiny_config()
    ds = get_dataset(cfg.data, "train")
    rays, pixels = ds.batch_stack(4, 16, seed=0, start_step=2)
    idx = torch.as_tensor(ds.index_stack(4, 16, seed=0, start_step=2))
    assert idx.dtype == torch.int32
    host, aux_h = make_train_loop(cfg)(
        _state(cfg), rays_to_device(rays, "cpu"), torch.as_tensor(pixels))
    bank = rays_to_device(ds.rays, "cpu"), torch.as_tensor(ds.pixels)
    banked, aux_b = make_banked_train_loop(cfg)(_state(cfg), *bank, idx)
    _assert_states_equal(banked, host)
    for k in aux_h:
        torch.testing.assert_close(aux_b[k], aux_h[k], rtol=0, atol=0)


# --- the trainer against the JAX package's ----------------------------------

@pytest.fixture(scope="module")
def jax_step2(tmp_path_factory):
    """A JAX step-2 checkpoint, no noise, one device, log_every=2."""
    ckpt = str(tmp_path_factory.mktemp("jax_step2"))
    argv = ["prog"] + _argv(SETS + [
        "train.max_steps=2", "train.batch_size=16", "train.log_every=2",
        "train.save_every=0", "train.eval_every=0", "train.randomized=false",
        "train.lr_delay_steps=0", "train.lr_max_steps=100", "mesh.data=1",
        f"train.checkpoint_dir={ckpt}"])
    old = sys.argv
    sys.argv = argv
    try:
        jax_train_app.main()
    finally:
        sys.argv = old
    assert os.path.exists(os.path.join(ckpt, "ckpt_2.msgpack"))
    return ckpt


def test_port_resumes_a_jax_run_as_jax_does(jax_step2, tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(jax_step2, jdir)
    shutil.copytree(jax_step2, tdir)
    resume = ["train.max_steps=6"]
    old = sys.argv
    sys.argv = ["prog", "--resume"] + _argv(
        resume + [f"train.checkpoint_dir={jdir}"])
    try:
        jax_train_app.main()
    finally:
        sys.argv = old
    state = train_app.main(["--resume", "--device", "cpu"] + _argv(
        resume + [f"train.checkpoint_dir={tdir}"]))
    assert (state.step, state.sched_count) == (6, 6)
    assert os.path.exists(os.path.join(tdir, "ckpt_6.pt"))

    with open(os.path.join(jdir, "config.json")) as f:
        jcfg = JConfig.from_json(f.read())
    template = jax_init_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train)
    want = jax_restore(jdir, template)
    assert int(want.step) == 6
    for i, (g, w) in enumerate(zip(leaves(state.params),
                                   jax.tree.leaves(want.params))):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=f"param leaf {i}", **PARAM_TOL)
    # The moments are sums over rays taken in another order, from params
    # that already differ at PARAM_TOL: their error scales with each leaf's
    # largest entry (tests/test_torch_train.py).
    for k in ("prop", "nerf"):
        adam = want.opt_state[k][0]
        assert state.opt_state[k].count == int(adam.count) == 6
        for name in ("mu", "nu"):
            for i, (g, w) in enumerate(zip(
                    leaves(getattr(state.opt_state[k], name)),
                    jax.tree.leaves(getattr(adam, name)))):
                w = np.asarray(w)
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=2e-4, atol=1e-4 * np.abs(w).max(),
                    err_msg=f"{name} {k} leaf {i}")
    got, want_losses = _losses(tdir), _losses(jdir)
    assert sorted(got) == sorted(want_losses) == [2, 4, 6]
    for s in (4, 6):
        np.testing.assert_allclose(got[s], want_losses[s], rtol=1e-4,
                                   err_msg=f"train/loss at step {s}")


# --- the port's trainer -----------------------------------------------------

def test_resume_is_exact_with_noise(tmp_path):
    straight = tiny_config(save_every=3, randomized=True, lr_max_steps=6,
                           checkpoint_dir=str(tmp_path / "straight"))
    split = dataclasses.replace(straight, train=dataclasses.replace(
        straight.train, checkpoint_dir=str(tmp_path / "split")))
    a = tr.train(straight, device="cpu")
    tr.train(split, max_steps=3, device="cpu")
    assert latest_checkpoint_step(split.train.checkpoint_dir) == 3
    b = tr.train(split, resume=True, device="cpu")
    _assert_states_equal(b, a)
    assert torch.equal(b.generator.get_state(), a.generator.get_state())
    la, lb = _losses(straight.train.checkpoint_dir), _losses(
        split.train.checkpoint_dir)
    assert sorted(la) == sorted(lb) == [3, 6]
    assert la == lb


def test_resume_extension_keeps_lr_schedule(tmp_path):
    cfg = tiny_config(max_steps=4, log_every=1, save_every=4,
                      checkpoint_dir=str(tmp_path / "ckpt"))
    tr.train(cfg, device="cpu")
    with open(tmp_path / "ckpt" / "config.json") as f:
        saved = json.load(f)
    assert saved["train"]["lr_max_steps"] == 4
    cfg2 = Config.from_json(json.dumps(saved))
    cfg2 = dataclasses.replace(
        cfg2, train=dataclasses.replace(cfg2.train, max_steps=8))
    lrs = {}
    tr.train(cfg2, resume=True, device="cpu",
             on_step=lambda s, sc: lrs.__setitem__(s, sc["train/lr"]))
    assert min(lrs) > 4  # actually resumed, not retrained
    for s, lr in lrs.items():
        assert lr == pytest.approx(cfg.train.lr_final, rel=1e-4), (s, lr)


@pytest.mark.parametrize("mode,async_", [("host", False), ("host", True),
                                         ("device_bank", False)])
def test_stage_modes_give_the_same_params(tmp_path, mode, async_):
    runs = {}
    for m, a in (("device_bank", True), (mode, async_)):
        cfg = tiny_config(stage_mode=m, async_staging=a,
                          checkpoint_dir=str(tmp_path / f"{m}{a}"))
        runs[m, a] = tr.train(cfg, device="cpu")
    _assert_states_equal(runs[mode, async_], runs["device_bank", True])


def test_keep_best_saves_and_survives_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    cfg = tiny_config(max_steps=4, log_every=2, eval_every=2,
                      eval_image_every=2, checkpoint_dir=ckpt)
    tr.train(cfg, device="cpu")
    best = os.path.join(ckpt, "ckpt_best.pt")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)
    assert {"best_psnr_image", "best_step"} <= set(manifest)
    assert manifest["latest_step"] == 4
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        keys = set().union(*(json.loads(line) for line in f))
    assert {"eval/psnr_batch_noisy", "eval/psnr_image",
            "eval/psnr_view_0", "eval/psnr_view_1"} <= keys
    # pretend the first run's best is unbeatable
    manifest["best_psnr_image"] = 999.0
    with open(os.path.join(ckpt, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    before = os.path.getmtime(best)
    cfg2 = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, max_steps=8))
    tr.train(cfg2, resume=True, device="cpu")
    assert os.path.getmtime(best) == before, \
        "resume overwrote ckpt_best with a worse checkpoint"


def test_missing_test_split_warns(tmp_path, monkeypatch):
    real = tr.get_dataset

    def no_test(cfg, split="train", white_bkgd=None):
        if split == "test":
            raise FileNotFoundError("transforms_test.json")
        return real(cfg, split, white_bkgd)

    monkeypatch.setattr(tr, "get_dataset", no_test)
    cfg = tiny_config(max_steps=2, log_every=1, eval_image_every=2,
                      checkpoint_dir=str(tmp_path))
    with pytest.warns(RuntimeWarning, match="TRAIN split"):
        tr.train(cfg, device="cpu")


def test_check_nans_aborts_naming_the_params(tmp_path, monkeypatch):
    cfg = tiny_config(max_steps=2, log_every=1, check_nans=True,
                      checkpoint_dir=str(tmp_path))
    real = tr.make_banked_train_loop

    def poisoned(cfg, **kwargs):
        loop = real(cfg, **kwargs)

        def run(state, *args):
            state, aux = loop(state, *args)
            with torch.no_grad():
                state.params["nerf"]["rgb"]["layers"][0]["b"][0] = float("nan")
            return state, aux
        return run

    monkeypatch.setattr(tr, "make_banked_train_loop", poisoned)
    with pytest.raises(checks.NonFiniteError,
                       match=r"\['nerf'\]\['rgb'\]\['layers'\]\[0\]\['b'\]"):
        tr.train(cfg, device="cpu")


def test_profile_dir_traces_the_chunk_holding_profile_start(tmp_path):
    prof = tmp_path / "prof"
    cfg = tiny_config(max_steps=4, log_every=2, profile_dir=str(prof),
                      profile_start=3, checkpoint_dir=str(tmp_path / "ckpt"))
    tr.train(cfg, device="cpu")
    assert os.listdir(prof) == ["trace_steps_2_4.json"]
    with open(prof / "trace_steps_2_4.json") as f:
        assert json.load(f)["traceEvents"]


def test_checks_count_and_name_nonfinite_leaves():
    tree = {"a": torch.tensor([1.0, float("nan"), float("inf")]),
            "b": [torch.tensor([0.5, float("nan")]), torch.arange(3), "x"],
            "c": (torch.tensor(float("inf")),)}
    assert int(checks.count_nonfinite(tree)) == 4
    assert checks.first_nonfinite_paths(tree) == [
        "['a']: 2 non-finite", "['b'][0]: 1 non-finite", "['c'][0]: 1 non-finite"]
    assert checks.first_nonfinite_paths(tree, max_report=1) == [
        "['a']: 2 non-finite"]
    assert int(checks.count_nonfinite({"i": torch.arange(2)})) == 0
    checks.assert_tree_finite({"ok": torch.ones(2)})


def test_mesh_other_than_one_device_raises(tmp_path, monkeypatch):
    """Without a process group a mesh of more than one rank raises (it does
    not train on one device), and so does ``--multihost`` outside
    torchrun."""
    for mesh in (MeshConfig(data=4, model=1), MeshConfig(data=-1, model=2)):
        cfg = dataclasses.replace(tiny_config(checkpoint_dir=str(tmp_path)),
                                  mesh=mesh)
        with pytest.raises(ValueError, match="multihost"):
            tr.train(cfg, device="cpu")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        train_app.main(["--multihost", "--device", "cpu"])


def test_background_stager_order_and_errors():
    starts = list(tr.chunk_starts(7, 50, 10))
    assert starts == [7, 10, 20, 30, 40]
    for a, b in zip(starts, starts[1:] + [50]):
        assert b - a == tr.chunk_len(a, 50, 10)
    stager = tr.BackgroundStager(lambda s: s * 2, starts, depth=2)
    got = []
    while (item := stager.get()) is not None:
        got.append(item)
    assert got == [s * 2 for s in starts]
    stager.close()

    def boom(s):
        raise RuntimeError("stage failed")

    stager = tr.BackgroundStager(boom, [1], depth=2)
    with pytest.raises(RuntimeError, match="stage failed"):
        stager.get()
    stager.close()


def test_use_device_bank_resolution(monkeypatch):
    cfg = tiny_config()
    ds = get_dataset(cfg.data, "train")
    with_mode = lambda m: dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, stage_mode=m))
    assert tr.use_device_bank(cfg, ds)
    assert not tr.use_device_bank(with_mode("host"), ds)
    monkeypatch.setattr(tr, "_BANK_AUTO_BYTES", 10)
    assert not tr.use_device_bank(cfg, ds)
    assert tr.use_device_bank(with_mode("device_bank"), ds)
    with pytest.raises(ValueError, match="stage_mode"):
        tr.use_device_bank(with_mode("hbm"), ds)


def test_sigterm_flushes_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mipnerf360_torch.apps.train", "--device", "cpu"]
        + _argv(SETS + ["train.max_steps=100000", "train.batch_size=16",
                        "train.log_every=5", "train.save_every=0",
                        "train.eval_every=0", f"train.checkpoint_dir={ckpt}"]),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        metrics = os.path.join(ckpt, "metrics.jsonl")
        deadline = time.time() + 300
        while time.time() < deadline:
            if os.path.exists(metrics) and os.path.getsize(metrics) > 0:
                break
            if proc.poll() is not None:
                pytest.fail(f"train exited early:\n{proc.stdout.read()}")
            time.sleep(0.2)
        else:
            pytest.fail("train never reached the first log boundary")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    step = latest_checkpoint_step(ckpt)
    assert step is not None and step > 0, out
    assert "preempted" in out, out
