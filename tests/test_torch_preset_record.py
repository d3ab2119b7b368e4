"""The preset record tool (``mipnerf360_torch/tools/preset_record.py``) on
the CPU: the TPU v5e record each run stands beside, read from the JAX
package's record files; the collapse and band rules; and one run end to
end at a tiny size, with the section's keys.
"""
import functools
import json
import os
import sys
from pathlib import Path

import pytest

from mipnerf360_torch.tools import preset_record as pr

REPO = Path(__file__).resolve().parents[1]
TINY = ["model.num_samples=8", "model.hidden_proposal=16",
        "model.hidden_nerf=32", "model.nerf_depth=2", "train.batch_size=64",
        "train.max_steps=4", "train.eval_image_every=2", "train.log_every=1"]


@pytest.mark.parametrize("run, best, ssim, restored, final, traj", [
    ("R1", 31.072, 0.9834, None, 31.07, {500: 28.2, 1000: 30.1, 1500: 31.07}),
    ("R2", 27.844, 0.9729, 1500, 27.23,
     {500: 26.39, 1000: 26.32, 1500: 27.84, 2000: 27.23}),
    ("R3", 35.926, 0.9844, None, 35.93,
     {500: 33.56, 1000: 32.5, 1500: 35.8, 2000: 35.93}),
    ("R4", 36.419, 0.9864, 5000, 36.05, None),
    # the NDC ablation records its trajectory only: its best is the
    # trajectory's largest value
    ("R5", 35.93, None, None, 35.93,
     {500: 33.56, 1000: 32.5, 1500: 35.8, 2000: 35.93}),
])
def test_record_for_each_run(run, best, ssim, restored, final, traj):
    rec = pr.record_for(run)
    assert rec["hardware"] == "TPU v5 lite (v5e), 1 chip"
    assert (rec["best_psnr"], rec["best_ssim"], rec["restored_step"],
            rec["final_psnr"]) == (best, ssim, restored, final)
    if traj is not None:
        assert rec["trajectory_mean_image_psnr"] == traj
    assert rec["source"].startswith("PRESET_VALIDATION_r")


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


def test_unknown_run_and_missing_card_are_refused(tmp_path):
    with pytest.raises(SystemExit, match="unknown runs"):
        pr.main(["--runs", "R9", "--device", "cpu"])
    if not __import__("torch").cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            pr.main(["--runs", "R3", "--out", str(tmp_path / "o.json")])
    assert not (tmp_path / "o.json").exists()


def test_one_run_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """R3 at 16x16 on a tiny model (the scene size and ``run_one``'s
    overrides patched in): export, apps.train, apps.eval --step best, and
    its section merged into --out."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    path = [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(path))
    monkeypatch.setattr(pr, "RES", 16)
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


def test_commands_are_shown_relative_to_the_repo():
    cmd = ["bash", str(REPO / "mipnerf360_torch" / "demo" / "demo_360.sh"),
           "--set", "data.factor=1"]
    assert pr.shown(cmd) == ("bash mipnerf360_torch/demo/demo_360.sh --set "
                             "data.factor=1")
    assert pr.shown([sys.executable, "-m", "x"]) == "python -m x"
