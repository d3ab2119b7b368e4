"""The port's measuring layer (``mipnerf360_torch/tools``) on the CPU at a
tiny size: the bench's arithmetic against the root ``bench.py``, its loops
against the production train loops, its JSON lines, its run over two gloo
ranks, the stager's ``warm()`` against the JAX package's, and the
profile, A/B and sample-axis tools.

Tolerances: the bench's loops are the production loops on the same state
and batches, so their losses are held bit for bit; the two-rank losses
against the one-process loop at tests/test_torch_parallel.py's float32
step tolerance (rtol 1e-4, atol 1e-6), the ranks' params against each
other bit for bit; the two ``weight_bounds`` forms at 1e-6.
"""
import dataclasses
import importlib.util
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_bench_cases import (B, K, REPEATS, TINY, TINY_MODEL, WARMUP,
                                bench_args)
from _torch_ranks import run_ranks
from mipnerf360_torch import config as tconfig
from mipnerf360_torch.core.rays import dummy_rays, rays_map, rays_to_device
from mipnerf360_torch.data import get_dataset
from mipnerf360_torch.tools import ab_step, bench, profile_step
from mipnerf360_torch.tools import sample_axis_bench as sab
from mipnerf360_torch.train import trainer as tr
from mipnerf360_torch.train.state import init_train_state, leaves
from mipnerf360_torch.train.step import make_train_loop
from mipnerf360_tpu import config as jconfig
from mipnerf360_tpu.train import trainer as jtr

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
CALLS = max(2, WARMUP) + REPEATS


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- matmul_flops_per_ray -----------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, tconfig.QUALITY_MODEL, {"pad_input_lanes": True},
    dict(num_samples=8, hidden_proposal=16, hidden_nerf=16, nerf_depth=2,
         proposal_depth=3)], ids=["default", "quality", "pad_lanes", "narrow"])
def test_matmul_flops_per_ray_matches_root_bench(kw):
    root = _root_bench()
    assert "jax" not in vars(root)       # no JAX at its module level
    want = root.matmul_flops_per_ray(jconfig.ModelConfig(**kw))
    assert bench.matmul_flops_per_ray(tconfig.ModelConfig(**kw)) == want


def test_mfu_is_against_the_h100_bf16_peak():
    cfg = bench.bench_config(bench_args("--quality"), tconfig.Config(), True)
    tflops, mfu = bench._mfu(cfg, 47000.0)
    assert bench.PEAK_TFLOPS_BF16 == 989.0
    assert tflops == pytest.approx(3 * 1.002e9 * 47000 / 1e12, rel=1e-3)
    assert mfu == tflops / 989.0


# --- BackgroundStager.warm against the JAX stager -----------------------------

STAGERS = {"jax": jtr.BackgroundStager, "torch": tr.BackgroundStager}


@pytest.mark.parametrize("impl", STAGERS)
def test_warm_fills_the_queue(impl):
    stager = STAGERS[impl](lambda s: s, range(10), depth=2)
    stager.warm(timeout=30)
    assert stager._q.qsize() == 2
    stager.close()


@pytest.mark.parametrize("impl", STAGERS)
def test_warm_returns_when_the_worker_ends(impl):
    stager = STAGERS[impl](lambda s: s, [0], depth=3)
    t0 = time.monotonic()
    stager.warm(timeout=30)
    assert time.monotonic() - t0 < 10
    assert not stager._thread.is_alive()
    assert stager.get() == 0 and stager.get() is None
    stager.close()


@pytest.mark.parametrize("impl", STAGERS)
def test_warm_returns_at_its_timeout(impl):
    release = threading.Event()

    def slow(s):
        release.wait(30)
        return s

    stager = STAGERS[impl](slow, range(3), depth=2)
    t0 = time.monotonic()
    stager.warm(timeout=0.2)
    waited = time.monotonic() - t0
    assert 0.2 <= waited < 10 and stager._q.qsize() == 0
    release.set()
    assert stager.get() == 0
    stager.close()


def test_warm_keeps_the_order_of_the_jax_stager():
    got = {}
    for impl, cls in STAGERS.items():
        stager = cls(lambda s: s * 3, tr.chunk_starts(7, 50, 10), depth=2)
        stager.warm(timeout=30)
        got[impl] = []
        while (item := stager.get()) is not None:
            got[impl].append(item)
        stager.close()
    assert got["torch"] == got["jax"] == [21, 30, 60, 90, 120]


@pytest.mark.parametrize("impl", STAGERS)
def test_warm_leaves_a_worker_error_to_get(impl):
    def boom(s):
        if s == 1:
            raise RuntimeError("stage failed")
        return s

    stager = STAGERS[impl](boom, range(3), depth=2)
    stager.warm(timeout=30)              # returns; does not raise
    assert stager.get() == 0
    with pytest.raises(RuntimeError, match="stage failed"):
        stager.get()
    stager.close()


# --- the bench's loops against the production loops ---------------------------

def _reference_losses(cfg, path: str):
    """The [K] losses of each of the bench's calls, run straight through
    make_train_loop on the batches the bench's path gives it."""
    state = init_train_state(cfg.model, cfg.train, device="cpu")
    loop = make_train_loop(cfg)
    if path == "compute":
        pix = np.random.default_rng(0).uniform(0, 1, (B, 3)).astype(np.float32)
        stack = lambda x: np.broadcast_to(x[None], (K,) + x.shape)
        batches = [(rays_map(stack, dummy_rays(B)), stack(pix))] * CALLS
    else:
        ds = get_dataset(cfg.data, "train", white_bkgd=cfg.model.white_bkgd)
        starts = ([i * K for i in range(max(2, WARMUP))]
                  + [(1000 + i) * K for i in range(REPEATS)])
        batches = [ds.batch_stack(K, B, cfg.train.seed, s) for s in starts]
    out = []
    for rays, pix in batches:
        state, aux = loop(state, rays_to_device(rays, "cpu"),
                          torch.as_tensor(np.array(pix)))
        out.append(aux["loss"])
    return out, state


@pytest.mark.parametrize("path", ["compute", "bank", "host"])
def test_bench_loop_is_the_train_loop_bit_for_bit(path):
    args = bench_args(*(["--stage-host"] if path == "host" else []))
    cfg = bench.bench_config(args, TINY, quality=True)
    m = bench.measure(args, cfg, path != "compute", "cpu")
    want, state = _reference_losses(cfg, path)
    assert len(m.losses) == CALLS and len(m.rays_per_sec) == REPEATS
    for got, ref in zip(m.losses, want):
        assert torch.equal(got, ref)
    for a, b in zip(leaves(m.state.params), leaves(state.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("stage_host", [False, True], ids=["bank", "host"])
def test_staging_assembles_repeats_plus_depth_chunks(stage_host, monkeypatch):
    args = bench_args(*(["--stage-host"] if stage_host else []))
    calls = []
    real = bench.stage_chunk
    monkeypatch.setattr(bench, "stage_chunk",
                        lambda *a: calls.append(a[6]) or real(*a))
    bench.measure(args, bench.bench_config(args, TINY, True), True, "cpu")
    depth = 1 if stage_host else 2
    # the warm-up chunks on the main thread, then the stager's
    assert calls == ([i * K for i in range(max(2, WARMUP))]
                     + [(1000 + i) * K for i in range(REPEATS + depth)])


def test_trainer_stages_through_the_lifted_functions(monkeypatch, tmp_path):
    """train() uploads its bank and stages every chunk through the
    module-level functions the bench calls."""
    seen = {"bank": 0, "chunks": []}
    real_bank, real_chunk = tr.upload_bank, tr.stage_chunk

    def bank(*a):
        seen["bank"] += 1
        return real_bank(*a)

    def chunk(dataset, bank_, device, k, *a):
        seen["chunks"].append(k)
        return real_chunk(dataset, bank_, device, k, *a)

    monkeypatch.setattr(tr, "upload_bank", bank)
    monkeypatch.setattr(tr, "stage_chunk", chunk)
    cfg = dataclasses.replace(TINY, train=dataclasses.replace(
        TINY.train, max_steps=5, batch_size=16, log_every=2, save_every=0,
        eval_every=0, eval_image_every=0, checkpoint_dir=str(tmp_path)))
    tr.train(cfg, device="cpu")
    assert seen == {"bank": 1, "chunks": [2, 2, 1]}


# --- the JSON lines -----------------------------------------------------------

TOP = {"metric", "value", "unit", "vs_baseline", "card", "detail"}
SINGLE = {"config", "staging", "matmul_tflops_per_chip", "mfu_matmul"}


@pytest.mark.parametrize("flags,keys,spread", [
    ((), TOP, {"parity_compute", "quality_compute", "quality_staging"}),
    (("--quality", "--mfu"), TOP | SINGLE, {"quality_compute"}),
    (("--staging", "--stage-host", "--quality"), TOP | SINGLE,
     {"quality_staging"}),
    (("--parity-only",), TOP, {"parity_compute"}),
    (("--mode", "render", "--quality"), TOP | {"config"}, {"render"}),
], ids=["default", "quality", "host_staging", "parity", "render"])
def test_bench_json_line(flags, keys, spread, capsys):
    out = bench.run(bench_args(*flags), TINY)
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == out
    assert set(out) == keys and out["card"] == "cpu"
    assert out["unit"] == "rays/s" and np.isfinite(out["value"])
    assert set(out["detail"]["spread"]) == spread
    for s in out["detail"]["spread"].values():
        assert s["windows"] == REPEATS and s["min"] <= s["max"]
    if "render" in flags:
        assert out["metric"] == "render_rays_per_sec_per_chip"
        assert out["vs_baseline"] is None
        return
    assert out["metric"] == "train_rays_per_sec_per_chip"
    ref = json.loads((REPO / "BASELINE_MEASURED.json").read_text())
    assert out["vs_baseline"] == pytest.approx(
        out["value"] / ref["reference_train_rays_per_sec"], abs=0.011)
    if not flags:
        assert set(out["detail"]) == {
            "headline", "parity_compute", "quality_compute",
            "quality_staging", "mfu_matmul_headline", "spread"}
        assert out["value"] == out["detail"]["quality_staging"]


def test_bench_over_two_gloo_ranks(tmp_path):
    ranks = run_ranks("_torch_bench_worker.py", 2, tmp_path)
    assert ranks[0]["printed"] > 0 and ranks[1]["printed"] == 0
    for name in ("compute", "bank"):
        np.testing.assert_array_equal(ranks[0][f"{name}_params"],
                                      ranks[1][f"{name}_params"])
        np.testing.assert_array_equal(ranks[0][f"{name}_losses"],
                                      ranks[1][f"{name}_losses"])
        args = bench_args()
        cfg = bench.bench_config(args, TINY, True)
        one = bench.measure(args, cfg, name == "bank", "cpu")
        np.testing.assert_allclose(ranks[0][f"{name}_losses"],
                                   torch.stack(one.losses).numpy(),
                                   err_msg=name, **STEP_TOL)
        np.testing.assert_allclose(
            ranks[0][f"{name}_params"],
            torch.cat([p.detach().flatten()
                       for p in leaves(one.state.params)]).numpy(),
            rtol=2e-4, atol=1e-6, err_msg=name)


# --- profile_step -------------------------------------------------------------

PIECES = ["nerf trunk fwd (matmul floor)", "nerf trunk fwd+bwd",
          "prop_forward", "nerf_forward (resample+encode+mlp+comp)",
          "encode (cast_rays+IPE)", "resample (blur+inv-CDF)",
          "distillation loss fwd+bwd", "distortion loss fwd+bwd",
          "FULL train step (joint)"]


@pytest.mark.parametrize("name", PIECES)
def test_profile_step_piece_runs(name):
    mcfg = dataclasses.replace(TINY_MODEL, **tconfig.QUALITY_MODEL)
    fns = dict(profile_step.pieces(mcfg, 16, torch.device("cpu")))
    assert list(fns) == PIECES
    out = fns[name]()
    for t in (out if isinstance(out, tuple) else (out,)):
        assert torch.isfinite(t).all()


def test_profile_step_line(capsys):
    out = profile_step.run(profile_step.parse_args(
        ["--device", "cpu", "--batch", "16", "--steps", "1"]), TINY_MODEL)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert [r["name"] for r in out["pieces"]] == PIECES
    assert all(r["device_ms"] is None and r["host_ms"] > 0
               for r in out["pieces"])
    assert out["card"] == "cpu"


# --- ab_step ------------------------------------------------------------------

def _ab(variant, *extra):
    return ab_step.run(ab_step.parse_args(
        [variant, "--device", "cpu", "--batch", "16", "--samples", "8",
         "--k", "2", *extra]), TINY_MODEL)


@pytest.mark.parametrize("variant", list(ab_step.VARIANTS))
def test_ab_step_variant_runs(variant):
    before = {v: getattr(*t[:2]) for v, t in ab_step.VARIANTS.items() if t}
    out, aux = _ab(variant)
    assert set(out) == {"variant", "batch", "num_samples", "ms_per_step",
                        "rays_per_sec", "card"}
    assert out["variant"] == variant and out["ms_per_step"] > 0
    assert all(torch.isfinite(v).all() for v in aux.values())
    if variant == "no_distortion":
        assert torch.all(aux["loss_dist"] == 0)
    elif variant == "no_distillation":
        assert torch.all(aux["loss_prop"] == 0)
    else:
        assert torch.all(aux["loss_dist"] > 0) and torch.all(aux["loss_prop"] > 0)
    # the stub is undone
    assert before == {v: getattr(*t[:2])
                      for v, t in ab_step.VARIANTS.items() if t}


def test_ab_step_bounds_forms_agree():
    _, einsum = _ab("bounds_einsum")
    _, banded = _ab("bounds_banded")
    for k in einsum:
        np.testing.assert_allclose(einsum[k].numpy(), banded[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_ab_step_unknown_variant_exits_nonzero():
    with pytest.raises(SystemExit) as e:
        ab_step.main(["no_such_piece", "--device", "cpu"])
    assert e.value.code not in (0, None)


def test_ab_step_unbound_stub_exits_before_timing(monkeypatch):
    """A step that holds its own reference to the piece never calls the
    stub: the identity check passes, the call check exits non-zero, and no
    window is timed."""
    from mipnerf360_torch.losses.photometric import photometric_loss
    from mipnerf360_torch.train import step as tstep

    held = tstep.distortion_loss

    def own_reference(train_cfg, out, pixels, group=None):
        loss_nerf, psnr = photometric_loss(out["rgb"], pixels, group)
        loss_dist = held(out["s_vals"], out["weights"],
                         train_cfg.dist_loss_reduction, group)
        return loss_nerf + train_cfg.dist_loss_weight * loss_dist, {
            "psnr": psnr, "loss_nerf": loss_nerf, "loss_dist": loss_dist}

    monkeypatch.setattr(tstep, "_nerf_losses", own_reference)
    timed = []
    monkeypatch.setattr(bench, "time_windows",
                        lambda *a: timed.append(a) or [1.0])
    with pytest.raises(SystemExit) as e:
        _ab("no_distortion")
    assert "not bound" in str(e.value.code) and not timed
    assert tstep.distortion_loss is held


# --- sample_axis_bench --------------------------------------------------------

def test_sample_axis_chunk_rule():
    assert [sab.chunk_for(n, 8192) for n in (64, 128, 256, 512, 1024)] == [
        8192, 4096, 2048, 1024, 512]
    assert sab.chunk_for(8, 16) == 256 and sab.chunk_for(4096, 8192) == 256


def test_sample_axis_rows_and_out(tmp_path, monkeypatch):
    """The rows from fixed window times: each rate is rounded to 0.1 on its
    own, as the JAX tool rounds them (tools/sample_axis_bench.py:87-88), so
    they are held to that rounding exactly (the product of the rounded
    rays/s and N differs from the rounded samples/s by up to 0.05 (N + 1))."""
    monkeypatch.chdir(tmp_path)
    durations = [0.7, 0.3, 0.9]       # seconds per window; the median is 0.7
    windows = []

    def fixed_windows(call, warmup, repeats):
        call()
        windows.append((warmup, repeats))
        return durations

    monkeypatch.setattr(sab, "time_windows", fixed_windows)
    root = REPO / "SAMPLE_AXIS_BENCH.json"
    before = root.read_bytes()
    rows = sab.run(sab.parse_args(["--device", "cpu", "--samples", "8", "16",
                                   "--chunk", "16"]), TINY_MODEL)
    assert list(tmp_path.iterdir()) == [] and root.read_bytes() == before
    assert windows == [(sab.WARMUP, sab.REPEATS)] * 2
    assert [(r["num_samples"], r["chunk"]) for r in rows] == [(8, 256),
                                                             (16, 256)]
    for r in rows:
        assert set(r) == {"num_samples", "chunk", "render_rays_per_sec",
                          "samples_per_sec", "card"}
        n_rays = 4 * r["chunk"]
        assert r["render_rays_per_sec"] == round(n_rays / 0.7, 1)
        assert r["samples_per_sec"] == round(n_rays / 0.7 * r["num_samples"],
                                             1)
        assert r["card"] == "cpu"
    out = tmp_path / "rows.json"
    rows = sab.run(sab.parse_args(["--device", "cpu", "--samples", "8",
                                   "--chunk", "16", "--out", str(out)]),
                   TINY_MODEL)
    assert json.loads(out.read_text())["single_chip"]["rows"] == rows
