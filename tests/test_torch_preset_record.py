"""The preset record tool (``mipnerf360_torch/tools/preset_record.py``) on
the CPU: the record each run stands beside, read from the JAX package's
record files (and for R10 from the port's own ``convergence`` run); the
collapse and band rules; and every run end to end at a tiny size, with its
section's keys, and ``--seeds``.

The runs start ``apps.train`` and friends as processes of their own. The
end-to-end tests hide ``tensorboard`` from those processes (a package on
their PYTHONPATH that raises ImportError, so the trainer's logger writes
its JSON lines only): importing it costs each process ~12 s on the CPU
and no test here reads its files.
"""
import functools
import json
import os
import sys
from pathlib import Path

import pytest

from mipnerf360_torch.tools import preset_record as pr
from mipnerf360_torch.train.schedule import log_lerp_lr

REPO = Path(__file__).resolve().parents[1]
TINY = ["model.num_samples=8", "model.hidden_proposal=16",
        "model.hidden_nerf=32", "model.nerf_depth=2", "train.batch_size=64",
        "train.max_steps=4", "train.eval_image_every=2", "train.log_every=1"]
TPU = "TPU v5 lite (v5e), 1 chip"
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# The videos' poses in the tiny runs (each pads its 16x16 frame to a chunk
# of 8,192 rays).
POSES = 6


@pytest.mark.parametrize("run, best, ssim, restored, final, traj, hardware", [
    ("R1", 31.072, 0.9834, None, 31.07, {500: 28.2, 1000: 30.1, 1500: 31.07},
     TPU),
    ("R2", 27.844, 0.9729, 1500, 27.23,
     {500: 26.39, 1000: 26.32, 1500: 27.84, 2000: 27.23}, TPU),
    ("R3", 35.926, 0.9844, None, 35.93,
     {500: 33.56, 1000: 32.5, 1500: 35.8, 2000: 35.93}, TPU),
    ("R4", 36.419, 0.9864, 5000, 36.05, None, TPU),
    # the NDC ablation records its trajectory only: its best is the
    # trajectory's largest value
    ("R5", 35.93, None, None, 35.93,
     {500: 33.56, 1000: 32.5, 1500: 35.8, 2000: 35.93}, TPU),
    ("R6", 35.926, 0.9844, None, 35.93,
     {500: 33.56, 1000: 32.5, 1500: 35.8, 2000: 35.93}, TPU),
    ("R7", 40.21, None, None, 40.21,
     {500: 32.54, 1000: 34.75, 1500: 33.8, 2000: 40.21}, TPU),
    ("R8", 20.15, None, None, 20.15,
     {500: 20.15, 1000: 20.15, 1500: 20.15, 2000: 20.15}, TPU),
    # the 1,500-step run and its resume extension; the best is the
    # 1,500-step checkpoint that the watermark keeps
    ("R9", 31.072, 0.9834, None, 30.19,
     {500: 28.2, 1000: 30.1, 1500: 31.07, 2000: 30.62, 2500: 30.21,
      3000: 30.51, 3500: 30.11, 4000: 30.19}, TPU),
    # convergence seed 0 on the card at the preset's eval cadence
    ("R10", 26.528, 0.9613, 1000, 26.455, {1000: 26.528, 2000: 26.455},
     CARD),
])
def test_record_for_each_run(run, best, ssim, restored, final, traj,
                             hardware):
    rec = pr.record_for(run)
    assert rec["hardware"] == hardware
    assert (rec["best_psnr"], rec["best_ssim"], rec["restored_step"],
            rec["final_psnr"]) == (best, ssim, restored, final)
    if traj is not None:
        assert rec["trajectory_mean_image_psnr"] == traj
    assert rec["source"].startswith("PARITY_PSNR_TORCH.json convergence"
                                    if run == "R10" else "PRESET_VALIDATION_r")


def test_record_videos_and_break():
    assert "0.07-0.12, max 0.86" in pr.record_for("R6")["video"]
    assert "0.05-0.08, max 0.93" in pr.record_for("R7")["video"]
    assert "video" not in pr.record_for("R3")
    brk = pr.record_for("R10")["break"]
    assert (brk["step"], brk["loss_prop"]) == (2145, 240952.03125)
    assert brk["source"] == "COLLAPSE_TORCH.json self_check.convergence_seed0"


def test_collapse_finds_the_first_fall_under_the_best():
    # seed 0 of convergence on the card (PARITY_PSNR_TORCH.json, PR 9)
    traj = json.loads((REPO / "PARITY_PSNR_TORCH.json").read_text())
    traj = {int(k): v for k, v in
            traj["convergence"]["ours"]["image_psnr"].items()}
    got = pr.collapse(traj, restored_step=2100)
    assert got == {"first_step": 2200, "best_restored_before_collapse": True}
    assert pr.collapse(traj, 2200)["best_restored_before_collapse"] is False
    steady = {500: 30.0, 1000: 25.0, 1500: 31.0}
    assert pr.collapse(steady, 1500) == {
        "first_step": None, "best_restored_before_collapse": True}
    assert pr.collapse({}, None)["best_restored_before_collapse"] is None


def test_band():
    assert pr.band(27.0, 27.84) == {"delta_db": -0.84, "within": True}
    assert pr.band(28.85, 27.84) == {"delta_db": 1.01, "within": False}
    assert pr.band(None, 27.84) == {"delta_db": None, "within": None}


def test_frame_luma_and_same_trace():
    import numpy as np

    black = np.zeros((4, 4, 3), np.uint8)
    grey = np.full((4, 4, 3), 51, np.uint8)
    grey[0, 0] = 255
    got = pr.frame_luma([black, grey])
    assert got["per_frame_mean"] == [0.0, round((15 * 0.2 + 1.0) / 16, 4)]
    assert got["per_frame_max"] == [0.0, 1.0]
    assert got["mean_range"] == [0.0, 0.25] and got["max_range"] == [0.0, 1.0]
    a = {"trajectory_mean_image_psnr": {2: 10.0}, "trajectory_mean_ssim": {},
         "final": {}, "eval_best_checkpoint": {"mean_psnr": 10.0}}
    assert pr.same_trace(a, dict(a)) == {"equal": True,
                                         "first_difference": None}
    b = dict(a, eval_best_checkpoint={"mean_psnr": 10.5})
    assert pr.same_trace(a, b) == {"equal": False,
                                   "first_difference": "eval_best_checkpoint"}


def test_unknown_run_and_missing_card_are_refused(tmp_path):
    with pytest.raises(SystemExit, match="unknown runs"):
        pr.main(["--runs", "R0", "--device", "cpu"])
    if not __import__("torch").cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            pr.main(["--runs", "R3", "--out", str(tmp_path / "o.json")])
    assert not (tmp_path / "o.json").exists()


def _small_runs(monkeypatch, tmp_path):
    """The end-to-end tests' environment: the repo importable, two threads,
    no tensorboard in the runs' processes, scenes of 16x16."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    hide = tmp_path / "no_tensorboard" / "tensorboard"
    hide.mkdir(parents=True)
    (hide / "__init__.py").write_text(
        "raise ImportError('tensorboard is hidden from this test run')\n")
    path = [str(REPO), str(hide.parent)] + [
        p for p in [os.environ.get("PYTHONPATH")] if p]
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(path))
    monkeypatch.setattr(pr, "RES", 16)


def test_one_run_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """R3 at 16x16 on a tiny model (the scene size and ``run_one``'s
    overrides patched in): export, apps.train, apps.eval --step best, and
    its section merged into --out."""
    _small_runs(monkeypatch, tmp_path)
    monkeypatch.setattr(pr, "run_one", functools.partial(pr.run_one,
                                                         sets=TINY))
    out = tmp_path / "record.json"
    got = pr.main(["--runs", "R3", "--device", "cpu", "--workdir",
                   str(tmp_path / "work"), "--out", str(out)])
    written = json.loads(out.read_text())
    assert set(written) == {"what", "llff_fern_quality_2000"}
    section = written["llff_fern_quality_2000"]
    assert got["llff_fern_quality_2000"]["run"] == "R3"
    assert section["card"] == "cpu" and section["steps"] == 4
    assert sorted(map(int, section["trajectory_mean_image_psnr"])) == [2, 4]
    best = section["eval_best_checkpoint"]
    assert best["n_views"] == 4 and len(best["per_view_psnr"]) == 4
    assert best["restored_step"] in (2, 4)
    assert section["final"]["step"] == 4
    assert section["record_tpu_v5e"]["best_psnr"] == 35.926
    assert section["collapse"]["first_step"] is None
    assert section["ms_per_step"] > 0 and section["trainer_rays_per_sec"] > 0
    assert set(section["best_vs_record"]) == {"delta_db", "within"}
    assert section["within_band"] is False    # 4 steps of a tiny model
    assert section["commands"][0].startswith(
        "python -m mipnerf360_torch.apps.train --preset llff_fern_quality")


@pytest.fixture(scope="module")
def new_runs(tmp_path_factory):
    """R3, R6, R7, R8 and R10 in one call of ``main`` at the tiny size,
    each video of POSES poses: (the sections it returned, what it wrote
    into --out)."""
    tmp = tmp_path_factory.mktemp("new_runs")
    mp = pytest.MonkeyPatch()
    try:
        _small_runs(mp, tmp)
        mp.setattr(pr, "run_one", functools.partial(
            pr.run_one, sets=[*TINY, f"data.n_render_poses={POSES}"]))
        out = tmp / "record.json"
        got = pr.main(["--runs", "R3,R6,R7,R8,R10", "--device", "cpu",
                       "--workdir", str(tmp / "work"), "--out", str(out)])
    finally:
        mp.undo()
    return got, json.loads(out.read_text())


def test_bicycle_multihost_quality_is_fern_and_renders_its_path(new_runs):
    """R6 trains as R3 did on the same scene, value for value, and renders
    the preset's spherified path."""
    got, written = new_runs
    sec = written["bicycle_multihost_quality_2000"]
    assert sec["vs_R3"] == {"equal": True, "first_difference": None}
    assert got["bicycle_multihost_quality_2000"]["vs_R3"] == sec["vs_R3"]
    r3 = written["llff_fern_quality_2000"]
    assert sec["trajectory_mean_image_psnr"] == r3["trajectory_mean_image_psnr"]
    assert sec["commands"][0].startswith(
        "python -m mipnerf360_torch.apps.train --preset "
        "bicycle_multihost_quality")
    assert sec["commands"][2].startswith("python -m mipnerf360_torch.apps.video")
    assert sec["video_frames"] == POSES
    luma = sec["video_luma"]
    assert len(luma["per_frame_mean"]) == len(luma["per_frame_max"]) == POSES
    assert 0 <= luma["mean_range"][0] <= luma["mean_range"][1] <= 1


def test_forward_facing_run_renders_the_spiral(new_runs):
    _, written = new_runs
    sec = written["llff_fern_quality_forward_facing_2000"]
    assert "--set data.n_render_poses=24" in sec["commands"][2]
    assert any("llff_arc40_16" in c for c in sec["commands"])
    assert sec["video_frames"] == POSES
    assert len(sec["video_luma"]["per_frame_max"]) == POSES
    assert sec["record_tpu_v5e"]["best_psnr"] == 40.21
    assert sec["eval_best_checkpoint"]["n_views"] == 4


def test_ndc_run_completes_with_its_first_nonfinite_step(new_runs):
    _, written = new_runs
    sec = written["garden_quality_ndc_2000"]
    assert "--set data.use_ndc=True" in sec["commands"][0]
    assert "first_nonfinite_step" in sec and "nonfinite_warning_step" in sec
    assert sec["first_nonfinite_step"] == sec["nonfinite_warning_step"]
    assert sec["check_nans"] is False
    assert sec["record_tpu_v5e"]["final_psnr"] == 20.15


def test_lego_run_stands_beside_convergence(new_runs):
    _, written = new_runs
    sec = written["blender_lego_quality_lr10000_2200"]
    train = sec["commands"][0]
    assert "--preset blender_lego_quality" in train
    for s in ("train.lr_max_steps=10000", "train.max_steps=2200",
              "train.log_every=5"):
        assert f"--set {s}" in train
    assert "record_convergence_h100" in sec and "record_tpu_v5e" not in sec
    brk = sec["break"]
    # 4 steps of a tiny model reach neither the break nor the evals
    assert brk["step"] == 2145 and brk["loss_prop"] is None
    assert brk["record_loss_prop"] == 240952.03125
    assert sorted(map(int, brk["image_evals_vs_record"])) == [1000, 2000]
    assert not any(e["equal"] for e in brk["image_evals_vs_record"].values())
    assert brk["first_train_psnr_difference"] is None


def test_resume_extension_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """R9 at a tiny size: demo_synthetic.sh for 4 steps, then the resume to
    8; the logged LR after the resume follows the schedule anchored at 4
    steps, and ``--step best`` keeps the watermark."""
    _small_runs(monkeypatch, tmp_path)
    monkeypatch.setenv("STEPS", "4")
    monkeypatch.setattr(pr, "RESUME_STEPS", 8)
    sets = [s for s in TINY if not s.startswith("train.max_steps")] + [
        "data.synthetic_resolution=16", "data.synthetic_views=4"]
    monkeypatch.setattr(pr, "run_one", functools.partial(pr.run_one,
                                                         sets=sets))
    got = pr.main(["--runs", "R9", "--device", "cpu", "--workdir",
                   str(tmp_path / "work")])
    sec = got["synthetic_quality_resume_4000"]
    assert [c.split()[:3] for c in sec["commands"]] == [
        ["bash", "mipnerf360_torch/demo/demo_synthetic.sh", "--set"],
        ["python", "-m", "mipnerf360_torch.apps.train"],
        ["python", "-m", "mipnerf360_torch.apps.eval"]]
    assert "--resume --set train.max_steps=8" in sec["commands"][1]
    assert sec["steps"] == 8
    assert sorted(sec["trajectory_mean_image_psnr"]) == [2, 4, 6, 8]
    res = sec["resume"]
    assert res["resumed_from_step"] == 4 and res["lr_max_steps"] == 4
    assert sorted(res["lr_after_resume"]) == [5, 6, 7, 8]
    assert res["lr_matches_anchored_schedule"] is True
    want = [float(log_lerp_lr(s - 1, 2e-3, 2e-5, 4, 2500, 0.01))
            for s in (5, 6, 7, 8)]
    assert [res["lr_after_resume"][s] for s in (5, 6, 7, 8)] == want
    # the warm-up delay (2,500 steps) keeps it under lr_final here
    assert res["lr_final_from_step"] is None
    assert max(want) < res["lr_final"] == pytest.approx(2e-5, rel=1e-6)
    assert res["lr_if_remapped_at_first_logged_step"] > want[0]
    restored = sec["eval_best_checkpoint"]["restored_step"]
    assert restored in (2, 4, 6, 8)
    assert res["best_is_resume_step"] is (restored == 4)
    assert res["eval_at_resume_step"] == sec["trajectory_mean_image_psnr"][4]
    assert sec["video_frames"] == 4 and "video_luma" in sec
    assert sec["env"]["DEVICE"] == "cpu"


def test_seeds_name_sections_and_reach_every_command(tmp_path, monkeypatch):
    """``--seeds 1,2``: R2 once per seed, each section named with its seed
    and carrying it, ``train.seed`` in each of its commands, and the two
    seeds training apart."""
    _small_runs(monkeypatch, tmp_path)
    run_one = pr.run_one
    monkeypatch.setattr(pr, "run_one", lambda run, args, work, env, sets=():
                        run_one(run, args, work, env, sets=(*sets, *TINY)))
    out = tmp_path / "record.json"
    got = pr.main(["--runs", "R2", "--seeds", "1,2", "--device", "cpu",
                   "--workdir", str(tmp_path / "work"), "--out", str(out)])
    names = ["blender_lego_quality_2000_seed1",
             "blender_lego_quality_2000_seed2"]
    assert list(got) == names
    assert set(json.loads(out.read_text())) == {"what", *names}
    for seed, name in ((1, names[0]), (2, names[1])):
        sec = got[name]
        assert sec["seed"] == seed and len(sec["commands"]) == 2
        for cmd in sec["commands"]:
            assert f"--set train.seed={seed}" in cmd
            assert f"seed{seed}" in cmd     # its own work directory
    assert (got[names[0]]["trajectory_mean_image_psnr"]
            != got[names[1]]["trajectory_mean_image_psnr"])


def test_commands_are_shown_relative_to_the_repo():
    cmd = ["bash", str(REPO / "mipnerf360_torch" / "demo" / "demo_360.sh"),
           "--set", "data.factor=1"]
    assert pr.shown(cmd) == ("bash mipnerf360_torch/demo/demo_360.sh --set "
                             "data.factor=1")
    assert pr.shown([sys.executable, "-m", "x"]) == "python -m x"
