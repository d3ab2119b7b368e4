"""The collapse record (``tests/_collapse_record.py``) on the CPU.

(a) Its layer statistics of the port's NeRF trunk and density head against
the same statistics, taken in NumPy, of the JAX package's layers
(``mipnerf360_tpu/models/mlp.py::apply_linear`` one by one) on the same
features, with the JAX ``init_model`` params converted by ``interop.py``:
pre-activation percentiles at rtol 2e-2 / atol 2e-2 (the bf16 rule), the
dead-unit share within 1/width, the zero-pair share within 1e-2.
(b) The statistics of a hand-made layer with known dead units, exactly.
(c) The script end to end at a tiny size: a few steps at 8x8, forced break
steps, every key of the record, written to a temporary directory only. The
module's size constants are patched, and its configs made tiny by wrapping
``run_config`` and ``preset_record.run_one`` from outside.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mipnerf360_tpu.config import get_config as jax_get_config
from mipnerf360_tpu.models import mipnerf360 as jm
from mipnerf360_tpu.models import mlp as jmlp
from mipnerf360_torch import interop
from mipnerf360_torch.apps.common import apply_overrides
from mipnerf360_torch.config import QUALITY_MODEL, get_config
from mipnerf360_torch.tools import preset_record
from mipnerf360_torch.train.step import _lr

torch.set_num_threads(2)

HERE = Path(__file__).parent
REPO = HERE.parent
TINY = dict(num_samples=8, hidden_proposal=16, hidden_nerf=32, nerf_depth=4,
            proposal_depth=2)
POINTS = 512


def _load(name):
    spec = importlib.util.spec_from_file_location(name, HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault(name, mod)
    spec.loader.exec_module(mod)
    return mod


cr = _load("_collapse_record")


def _np_unit_stats(pre, post):
    zero = post.reshape(-1, post.shape[-1]) == 0
    p = np.percentile(pre.astype(np.float64), cr.PERCENTILES)
    return {"dead_units": zero.all(0).mean(), "zero_pairs": zero.mean(),
            "pre_p1": p[0], "pre_p50": p[1], "pre_p99": p[2],
            "pre_max": pre.max()}


def _jax_tower_stats(jparams, x, cfg):
    """The record's statistics of the JAX package's trunk and density head,
    layer by layer, taken in NumPy."""
    h = jnp.asarray(x)
    layers = jparams["nerf"]["trunk"]["layers"]
    out = []
    for i, layer in enumerate(layers):
        y = jmlp.apply_linear(layer, h, jnp.bfloat16)
        hidden = i + 1 < len(layers)
        h = jax.nn.relu(y.astype(jnp.bfloat16) if hidden else y)
        out.append(_np_unit_stats(np.asarray(y),
                                  np.asarray(h.astype(jnp.float32))))
    y = jmlp.apply_linear(jparams["nerf"]["density"]["layers"][0],
                          h.astype(jnp.float32), jnp.bfloat16)
    head = _np_unit_stats(np.asarray(y), np.asarray(y))
    z = np.asarray(y[..., 0] + cfg.density_bias)
    dens = np.asarray(jax.nn.softplus(jnp.asarray(z)))
    vals = lambda v: dict(zip(("p1", "p50", "p99"), np.percentile(
        v.astype(np.float64), cr.PERCENTILES)), max=v.max())
    return out, head, {"pre": vals(z), "softplus": vals(dens)}


@pytest.fixture(scope="module")
def both():
    model = dict(TINY, **QUALITY_MODEL)
    jcfg = jax_get_config(model=model)
    tcfg = get_config(model=model)
    jparams = jm.init_model(jax.random.PRNGKey(3), jcfg.model)
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (POINTS, tcfg.model.padded_input_dim)).astype(
        np.float32)
    x[:, tcfg.model.input_dim:] = 0.0
    got = cr.tower_stats(tcfg, tparams["nerf"], torch.as_tensor(x))
    return got, _jax_tower_stats(jparams, x, jcfg.model), tcfg


@pytest.mark.parametrize("layer", range(TINY["nerf_depth"]))
def test_trunk_layer_stats_match_the_jax_package(both, layer):
    got, (want, _, _), _ = both
    g, w = got["trunk"][layer], want[layer]
    width = TINY["hidden_nerf"]
    assert abs(g["dead_units"] - w["dead_units"]) <= 1.0 / width
    assert abs(g["zero_pairs"] - w["zero_pairs"]) <= 1e-2
    for k in ("pre_p1", "pre_p50", "pre_p99", "pre_max"):
        np.testing.assert_allclose(g[k], w[k], rtol=2e-2, atol=2e-2,
                                   err_msg=k)


def test_density_head_and_density_match_the_jax_package(both):
    got, (_, head, dens), _ = both
    assert got["density_head"]["dead_units"] == head["dead_units"] == 0.0
    for k in ("pre_p1", "pre_p50", "pre_p99", "pre_max"):
        np.testing.assert_allclose(got["density_head"][k], head[k],
                                   rtol=2e-2, atol=2e-2, err_msg=k)
    for part in ("pre", "softplus"):
        for k in ("p1", "p50", "p99", "max"):
            np.testing.assert_allclose(got["density"][part][k],
                                       dens[part][k], rtol=2e-2, atol=2e-2,
                                       err_msg=f"{part}.{k}")


def test_trunk_sees_every_layer_once_and_only_the_nerf(both):
    got, _, tcfg = both
    assert len(got["trunk"]) == tcfg.model.nerf_depth
    assert set(got["trunk"][0]) == {"dead_units", "zero_pairs", "pre_p1",
                                    "pre_p50", "pre_p99", "pre_max"}


def test_hand_made_layer_with_known_dead_units():
    """Four units on 1-D inputs x: two never fire (w 0, b -1), one always
    (w 0, b 1), one is x itself, zero on the negative half."""
    x = (torch.arange(-50, 51) / 25.0).reshape(-1, 1)
    layer = {"w": torch.tensor([[0.0, 0.0, 0.0, 1.0]]),
             "b": torch.tensor([-1.0, -1.0, 1.0, 0.0])}
    head = {"w": torch.ones(4, 1), "b": torch.zeros(1)}
    nerf = {"trunk": {"layers": [layer]}, "density": {"layers": [head]}}
    cfg = get_config(model=dict(QUALITY_MODEL, compute_dtype="float32",
                                nerf_depth=1))
    got = cr.tower_stats(cfg, nerf, x)
    pre = np.concatenate([np.full((101, 2), -1.0), np.ones((101, 1)),
                          x.numpy().astype(np.float64)], 1)
    (stats,) = got["trunk"]
    assert stats["dead_units"] == 0.5
    # 202 of the dead units, 51 of x <= 0 (x = 0 included)
    assert stats["zero_pairs"] == (202 + 51) / 404
    want = np.percentile(pre, cr.PERCENTILES)
    for q, w in zip(cr.PERCENTILES, want):
        assert stats[f"pre_p{q}"] == pytest.approx(w, abs=1e-12)
    assert stats["pre_max"] == 2.0
    # the head sums the outputs: 1 + relu(x), never 0
    assert got["density_head"]["dead_units"] == 0.0
    assert got["density_head"]["zero_pairs"] == 0.0
    assert got["density_head"]["pre_max"] == 3.0
    assert got["density"]["pre"]["max"] == pytest.approx(3.0 - 5.0)


def test_percentiles_are_numpys():
    v = np.random.default_rng(0).normal(size=1001).astype(np.float32)
    got = cr.percentiles(torch.as_tensor(v), (0, 1, 37.5, 50, 99, 100))
    want = np.percentile(v.astype(np.float64), (0, 1, 37.5, 50, 99, 100))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


SMALL = dict(num_samples=8, hidden_proposal=16, hidden_nerf=32, nerf_depth=4,
             proposal_depth=2, compute_dtype="float32")
SMALL_SETS = [f"model.{k}={v}" for k, v in SMALL.items()] + [
    "train.log_every=1"]
RUNS = {"convergence_seed0": dict(seed=0, windows=[(4, 6)]),
        "convergence_seed1": dict(seed=1, windows=[(4, 5)]),
        "convergence_seed2": dict(seed=2, windows=[(4, 4), (6, 6)]),
        "convergence_seed3": dict(seed=3, windows=[(4, 4), (6, 6)]),
        "llff_fern_quality_seed0": dict(seed=0, preset="llff_fern_quality",
                                        windows=[(5, 6)])}
PRESET_TINY = ["model.num_samples=8", "model.hidden_proposal=16",
               "model.hidden_nerf=32", "model.nerf_depth=2",
               "train.batch_size=64", "train.max_steps=4",
               "train.eval_image_every=2", "train.log_every=1"]


def _tiny(mp, runs_a, probe_rays, self_check):
    """Patch the record's module down to the test's size."""
    for name, value in (("RES", 8), ("BATCH", 32), ("PROBE_EVERY", 2),
                        ("PROBE_RAYS", probe_rays), ("RUNS_A", runs_a),
                        ("SELF_CHECK", self_check), ("PRESET_RUNS", ("R2",)),
                        ("PRESET_SEEDS", (2,))):
        mp.setattr(cr, name, value)
    run_config, run_one = cr.run_config, preset_record.run_one
    mp.setattr(cr, "run_config", lambda *a: apply_overrides(
        run_config(*a), SMALL_SETS))
    mp.setattr(preset_record, "run_one", lambda run, args, work, env, sets=():
               run_one(run, args, work, env, sets=(*sets, *PRESET_TINY)))
    mp.setattr(preset_record, "RES", 16)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    out = tmp_path_factory.mktemp("collapse") / "record.json"
    repo_file = REPO / "COLLAPSE_TORCH.json"
    before = repo_file.stat().st_mtime_ns if repo_file.exists() else None
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "2")
    path = [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]
    mp.setenv("PYTHONPATH", os.pathsep.join(path))
    _tiny(mp, RUNS, 24, {})
    try:
        rec = cr.run(str(out), device="cpu")
    finally:
        mp.undo()
    after = repo_file.stat().st_mtime_ns if repo_file.exists() else None
    return out, rec, (before, after)


def test_record_written_with_every_key(recorded):
    out, rec, (before, after) = recorded
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert before == after, "the record wrote into the repo"
    assert set(rec) == {"what", "card", "torch", "cuda", "config", "part_a",
                        "self_check", "break_summary", "precursors",
                        "part_b", "part_b_collapsed", "seconds"}
    assert rec["card"] == "cpu" and rec["self_check"] == {}
    assert list(rec["part_a"]) == list(RUNS)


@pytest.mark.parametrize("name", list(RUNS))
def test_part_a_run(recorded, name):
    _, rec, _ = recorded
    sec = rec["part_a"][name]
    spec = RUNS[name]
    assert sec["seed"] == spec["seed"] and sec["probe_rays"] == 24
    # the trajectory every 2 steps from step 0, each with its window's
    # train PSNR and loss_prop after the first
    steps = [e["step"] for e in sec["trajectory"]]
    assert steps == list(range(0, sec["trained_to"] + 1, 2))
    assert "window" not in sec["trajectory"][0]
    assert sec["trajectory"][1]["window"]["steps"] == 2
    probe = sec["trajectory"][0]["probe"]
    assert len(probe["trunk"]) == SMALL["nerf_depth"]
    assert 0.0 <= probe["acc_mean"] <= 1.0 and len(probe["rgb_mean"]) == 3
    assert len(sec["windows"]) == len(spec["windows"])
    for w, (lo, hi) in zip(sec["windows"], spec["windows"]):
        assert w["window"] == [lo, hi] and lo <= w["spike"] <= hi
        assert w["break_step"] == w["spike"] - 1
        ks = [e["k"] for e in w["steps"]]
        # the steps end at the first over SPIKE, else at the window's end
        last = (w["spike"] if w["spike_rule"].startswith("first") else hi)
        assert ks == list(range(ks[0], last + 1))
        if lo == hi:
            assert w["spike_rule"] == "the window's one step"
        for where in ("batch", "probe"):
            p = w[where]
            assert len(p["before"]["trunk"]) == len(p["after"]["trunk"])
            assert len(p["output_change"]) == SMALL["nerf_depth"]
            assert all(c["rel"] >= 0 and c["rel_own"] >= 0
                       for c in p["output_change"])
        # an update moved every trunk leaf
        trunk = {k: v for k, v in w["update"].items()
                 if k.startswith("nerf.trunk.")}
        assert len(trunk) == 2 * SMALL["nerf_depth"]
        assert all(v["rel_norm"] > 0 and v["max_abs"] > 0
                   for v in trunk.values())


def test_the_fork_takes_the_trainers_own_steps(recorded):
    """Seed 2's windows fork the state at steps 2 and 4; the fork's steps
    repeat the trainer's: the train PSNR the trainer logged for steps 3-4
    equals the fork's."""
    _, rec, _ = recorded
    sec = rec["part_a"]["convergence_seed2"]
    first = sec["windows"][0]["steps"]
    assert [e["k"] for e in first] == [3, 4]
    window = next(e["window"] for e in sec["trajectory"] if e["step"] == 4)
    np.testing.assert_allclose(window["train_psnr_mean"],
                               np.mean([e["psnr"] for e in first]),
                               rtol=1e-6)
    later = sec["windows"][1]["steps"]
    assert later[0]["k"] == 5


def test_summaries(recorded):
    _, rec, _ = recorded
    summary = rec["break_summary"]
    assert set(summary) == {"convergence_seed0@" + str(
        rec["part_a"]["convergence_seed0"]["windows"][0]["break_step"]),
        "convergence_seed1@" + str(
        rec["part_a"]["convergence_seed1"]["windows"][0]["break_step"]),
        "convergence_seed2@3", "convergence_seed2@5",
        "convergence_seed3@3", "convergence_seed3@5",
        "llff_fern_quality_seed0@" + str(
        rec["part_a"]["llff_fern_quality_seed0"]["windows"][0]["break_step"])}
    for s in summary.values():
        assert 0 <= s["largest_rel_own_layer"] < SMALL["nerf_depth"]
        assert len(s["rel_own"]) == len(s["dead_rise"]) == SMALL["nerf_depth"]
    pre = rec["precursors"]
    assert pre["common_steps"] == [0, 2]
    for v in pre["stats"].values():
        assert set(v) == {"separated", "from", "last_probe"}


def test_part_b_section(recorded):
    _, rec, _ = recorded
    (key,) = rec["part_b"]
    assert key == "R2_seed2"
    sec = rec["part_b"][key]
    assert sec["seed"] == 2 and sec["collapsed"] is False
    assert rec["part_b_collapsed"] == 0
    assert sec["commands"][0].endswith("--set train.seed=2 " + " ".join(
        f"--set {s}" for s in PRESET_TINY))
    assert set(sec["collapse"]) >= {"first_step",
                                    "max_train_loss_prop_after_first_eval"}


def test_failed_self_check_stops_the_record(tmp_path, monkeypatch):
    out = tmp_path / "record.json"
    _tiny(monkeypatch, {"convergence_seed1": RUNS["convergence_seed1"]}, 16,
          {"convergence_seed1": (4, 1e9)})
    with pytest.raises(SystemExit, match="self-check failed"):
        cr.run(str(out), device="cpu")
    rec = json.loads(out.read_text())
    assert rec["self_check"]["convergence_seed1"]["ok"] is False
    assert "part_b" not in rec


def test_window_before_the_first_chunk_is_refused():
    with pytest.raises(ValueError, match="before the first chunk"):
        cr.Tracker(get_config(), None, None, None, [(3, 4)], 100)


def test_script_imports_no_jax():
    code = ("import sys; sys.path.insert(0, 'tests'); import _collapse_record;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mipnerf360_tpu', 'tools')];"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=""),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cli_refuses_without_a_card(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            cr.main(["--out", str(tmp_path / "o.json")])
    with pytest.raises(SystemExit):
        cr.main(["--device", "cpu"])
    assert not (tmp_path / "o.json").exists()


def test_preset_record_lr_horizon():
    """Part B's runs decay the LR over their own 1,500 or 2,000 steps
    (``lr_max_steps`` 0), so it peaks under a third of the LR of the
    updates that broke ``convergence``; the presets' own 10,000-step
    horizon passes it. Horizons and break LRs from ``COLLAPSE_TORCH.json``."""
    rec = json.loads((REPO / "COLLAPSE_TORCH.json").read_text())
    breaks = [e["lr"] for name, k in (("convergence_seed0", 2144),
                                      ("convergence_seed1", 1031))
              for e in rec["part_a"][name]["windows"][0]["steps"]
              if e["k"] == k]
    assert len(breaks) == 2
    presets = {"R1": "synthetic_quality", "R2": "blender_lego_quality",
               "R3": "llff_fern_quality"}

    def peak(train_cfg):
        return max(float(_lr(train_cfg, k))
                   for k in range(train_cfg.max_steps))

    runs = {(sec["run"], sec["steps"]) for sec in rec["part_b"].values()}
    assert runs == {("R1", 1500), ("R2", 2000), ("R3", 2000)}
    for run, steps in sorted(runs):
        cfg = get_config(presets[run]).train
        assert cfg.lr_max_steps == 0 and cfg.max_steps == 10_000
        short = peak(dataclasses.replace(cfg, max_steps=steps))
        assert short == pytest.approx({1500: 1.557e-4, 2000: 2.040e-4}[steps],
                                      rel=1e-3), run
        assert short < 0.3 * min(breaks), run
        assert peak(cfg) == pytest.approx(8.129e-4, rel=1e-3), run
        assert peak(cfg) > max(breaks), run
