"""The preset record: the JAX package's validations of its shipping presets
(``PRESET_VALIDATION_r4.json``, ``_r5.json``, taken on a TPU v5e) repeated
through the port's demo scripts and entry points.

    python -m mipnerf360_torch.tools.preset_record --out PRESET_VALIDATION_TORCH.json
    python -m mipnerf360_torch.tools.preset_record --runs R2,R3 --out PATH

The runs, each at its preset's full width, on a scene that the port's
exporters write (``tools/parity_psnr.py``), nothing downloaded:

- R1: ``demo/demo_synthetic.sh`` at its 1,500 steps (train, eval
  ``--step best``, video), beside ``synthetic_quality_r5_reproduction``;
- R2: ``apps.train --preset blender_lego_quality`` on
  ``export_blender_scene(RES)`` at ``data.factor=1`` for 2,000 steps, an
  image eval every 500, then ``apps.eval --step best``, beside
  ``blender_lego_quality_standin``;
- R3: ``llff_fern_quality`` on ``export_llff_scene(RES, n_views=32)``, the
  same way, beside ``llff_fern_quality``;
- R4: the same at the preset's own 10,000 steps and eval cadence, beside
  ``llff_fern_quality_full_schedule``;
- R5: ``demo/demo_360.sh`` (``garden_quality``) with ``DATA`` = R3's scene
  and ``--set data.factor=1 --set train.max_steps=2000 --set
  train.eval_image_every=500``, beside
  ``garden_quality_ndc_ablation.ndc_free``.

Each run's section holds its commands, the card (``nvidia-smi`` name and
power limit), the trainer's image-PSNR and SSIM trajectory
(``metrics.jsonl``), the final value (the trainer's image eval at the last
step), the ``--step best`` eval (restored step, mean and per-view PSNR and
SSIM), whether the trajectory collapsed (an image eval more than
``COLLAPSE_DB`` under the best before it) and whether ``best`` restored a
model from before that, the ms per step and the trainer's rays/s (the
median of the logged chunks that follow no image eval), the record beside
it, and whether the best and the final each lie within ``BAND_DB`` of the
record's. ``run_one``'s ``sets`` go to the end of every command (the demo
scripts pass their arguments on): its tests run it at a smaller size on
the CPU. Sections are merged into ``--out``; the scenes and checkpoints live in a
temporary directory unless ``--workdir``. Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from ..apps.video import written_frames
from .bench import card_name
from .parity_psnr import (export_blender_scene, export_llff_scene, merge_out,
                          ms_per_step, parse_ours_metrics)

REPO = Path(__file__).resolve().parents[2]
DEMO = REPO / "mipnerf360_torch" / "demo"
APPS = "mipnerf360_torch.apps"
# The band of PERF.md section 2 (PR 9): the best and the final each within
# this many dB of the record's.
BAND_DB = 1.0
# An image eval this far under the best before it counts as a collapse (the
# convergence spike took 27 dB to 2-5 dB).
COLLAPSE_DB = 10.0
EVAL_EVERY = 500
# Pixels per side of the exported scenes.
RES = 64
# Seconds each command may take (R4 trains for about 16 min on an H100).
COMMAND_TIMEOUT_S = 3600

WHAT = ("The JAX package's validations of its shipping presets "
        "(PRESET_VALIDATION_r4.json, _r5.json, taken on a TPU v5e) repeated "
        "through the PyTorch port's demo scripts and entry points, each run "
        "beside its record: python -m mipnerf360_torch.tools.preset_record "
        "(see that module). Scenes written by the exporters of "
        "mipnerf360_torch/tools/parity_psnr.py; band: the best and the "
        "final each within 1.0 dB of the record's.")
# Each run: (its section, (the record's file, the key path in it)).
RUNS = {
    "R1": ("synthetic_quality_demo",
           ("PRESET_VALIDATION_r5.json", "synthetic_quality_r5_reproduction")),
    "R2": ("blender_lego_quality_2000",
           ("PRESET_VALIDATION_r4.json", "blender_lego_quality_standin")),
    "R3": ("llff_fern_quality_2000",
           ("PRESET_VALIDATION_r5.json", "llff_fern_quality")),
    "R4": ("llff_fern_quality_10000",
           ("PRESET_VALIDATION_r5.json", "llff_fern_quality_full_schedule")),
    "R5": ("garden_quality_demo_360",
           ("PRESET_VALIDATION_r5.json", "garden_quality_ndc_ablation",
            "ndc_free")),
}


def _float_keys(d: dict) -> dict:
    return {int(k): float(v) for k, v in d.items()}


def record_for(run: str) -> dict:
    """The TPU v5e record a run stands beside: its trajectory, best (PSNR,
    SSIM, restored step where recorded) and final, read from the JAX
    package's record files."""
    path, *keys = RUNS[run][1]
    node = record = json.loads((REPO / path).read_text())
    for k in keys:
        node = node[k]
    hardware = record["hardware"]
    traj = _float_keys(node.get("trajectory_mean_image_psnr", {}))
    best = node.get("eval_best_checkpoint", {})
    best_psnr = next((v for k, v in best.items()
                      if k.startswith("mean_psnr")), None)
    best_ssim = next((v for k, v in best.items()
                      if k.startswith("mean_ssim")), None)
    restored = best.get("restored_step")
    if restored is None and isinstance(best.get("restored"), str):
        restored = int(best["restored"].split()[1])
    if best_psnr is None and traj:
        # garden's NDC ablation records its trajectory only
        best_psnr = max(traj.values())
    return {"source": f"{path} {'.'.join(keys)}", "hardware": hardware,
            "trajectory_mean_image_psnr": traj,
            "best_psnr": best_psnr, "best_ssim": best_ssim,
            "restored_step": restored,
            "final_psnr": traj[max(traj)] if traj else None}


def collapse(traj: dict, restored_step: Optional[int]) -> dict:
    """The first image eval more than ``COLLAPSE_DB`` under the best before
    it (None: no collapse), and whether ``restored_step`` lies before it."""
    first, best = None, float("-inf")
    for step in sorted(traj):
        if traj[step] < best - COLLAPSE_DB:
            first = step
            break
        best = max(best, traj[step])
    return {"first_step": first,
            "best_restored_before_collapse": (
                None if restored_step is None else
                first is None or restored_step < first)}


def band(value: Optional[float], want: Optional[float]) -> dict:
    if value is None or want is None:
        return {"delta_db": None, "within": None}
    delta = round(value - want, 3)
    return {"delta_db": delta, "within": abs(delta) <= BAND_DB}


def python_shim_dir(work: Path) -> Path:
    """A directory whose ``python`` runs this interpreter, for the demo
    scripts' ``python -m`` commands (a script, not a link: a virtual
    environment's interpreter finds its packages only under its own
    path)."""
    bin_dir = work / "bin"
    bin_dir.mkdir(exist_ok=True)
    shim = bin_dir / "python"
    shim.write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    shim.chmod(0o755)
    return bin_dir


def shown(cmd: list) -> str:
    """``cmd`` as the record writes it: ``python`` for this interpreter and
    paths inside the repo relative to it."""
    return " ".join("python" if c == sys.executable else
                    c.replace(f"{REPO}{os.sep}", "") for c in cmd)


def _run(cmd: list, log: Path, env: dict) -> None:
    with open(log, "a") as f:
        f.write("$ " + " ".join(cmd) + "\n")
        f.flush()
        res = subprocess.run(cmd, cwd=REPO, env=env, stdout=f,
                             stderr=subprocess.STDOUT,
                             timeout=COMMAND_TIMEOUT_S)
    if res.returncode != 0:
        raise SystemExit(f"{' '.join(cmd)} exited {res.returncode}:\n"
                         + log.read_text()[-6000:])


def run_one(run: str, args, work: Path, env: dict, sets=()) -> dict:
    """Train, eval (and for the demos the video) one run; its section.
    ``sets`` (``K=V`` config overrides) go to the end of every command."""
    name = RUNS[run][0]
    ckpt = work / name
    log = work / f"{name}.log"
    sets = [x for s in sets for x in ("--set", s)]
    dev = ["--device", args.device]
    eval_every = ["--set", f"train.eval_image_every={EVAL_EVERY}"]
    scene = work / (f"blender_{RES}" if run == "R2" else f"llff_{RES}")
    if run == "R2" and not scene.exists():
        export_blender_scene(str(scene), RES)
    elif run != "R1" and not scene.exists():
        export_llff_scene(str(scene), RES, n_views=32)
    run_env = dict(env, DEVICE=args.device, CKPT=str(ckpt))
    if run == "R1":
        cmds = [["bash", str(DEMO / "demo_synthetic.sh"), *sets]]
    elif run == "R5":
        run_env["DATA"] = str(scene)
        cmds = [["bash", str(DEMO / "demo_360.sh"), "--set", "data.factor=1",
                 "--set", "train.max_steps=2000", *eval_every, *sets]]
    else:
        preset = ("blender_lego_quality" if run == "R2"
                  else "llff_fern_quality")
        steps = [] if run == "R4" else ["--set", "train.max_steps=2000",
                                        *eval_every]
        cmds = [
            [sys.executable, "-m", f"{APPS}.train", "--preset", preset,
             "--set", f"data.base_dir={scene}", "--set", "data.factor=1",
             *steps, "--set", f"train.checkpoint_dir={ckpt}", *dev, *sets],
            [sys.executable, "-m", f"{APPS}.eval", "--ckpt", str(ckpt),
             "--step", "best", *dev, *sets]]
    t0 = time.time()
    for cmd in cmds:
        print(f"{run}: {' '.join(cmd)}", flush=True)
        _run(cmd, log, run_env)
    wall = time.time() - t0

    cfg = json.loads((ckpt / "config.json").read_text())
    metrics = parse_ours_metrics(str(ckpt))
    traj = {int(k): round(v, 3) for k, v in metrics["image_psnr"].items()}
    ssim = {int(k): round(v, 4) for k, v in metrics["image_ssim"].items()}
    best = json.loads((ckpt / "test" / "eval.json").read_text())
    final_step = max(traj) if traj else None
    rec = record_for(run)
    loss_prop = metrics_max(ckpt, "train/loss_prop", after=EVAL_EVERY)
    ms = ms_per_step(str(ckpt))
    out = {
        "run": run,
        "commands": [shown(c) for c in cmds],
        "env": {k: run_env[k] for k in ("DEVICE", "CKPT", "DATA")
                if k in run_env and run in ("R1", "R5")},
        "card": args.card,
        "torch": f"{torch.__version__} cuda {torch.version.cuda}",
        "steps": cfg["train"]["max_steps"],
        "batch": cfg["train"]["batch_size"],
        "trajectory_mean_image_psnr": traj,
        "trajectory_mean_ssim": ssim,
        "final": {"step": final_step,
                  "mean_psnr": traj.get(final_step),
                  "mean_ssim": ssim.get(final_step)},
        "eval_best_checkpoint": {
            "restored_step": best["step"], "n_views": best["n_views"],
            "mean_psnr": round(best["mean_psnr"], 3),
            "mean_ssim": (round(best["mean_ssim"], 4)
                          if "mean_ssim" in best else None),
            "per_view_psnr": [round(p, 2) for p in best["per_view_psnr"]]},
        "collapse": dict(collapse(traj, best["step"]),
                         max_train_loss_prop_after_first_eval=loss_prop),
        "ms_per_step": None if ms is None else round(ms, 3),
        "trainer_rays_per_sec": (None if ms is None else
                                 round(cfg["train"]["batch_size"] * 1e3 / ms,
                                       1)),
        "wall_s": round(wall, 1),
        "record_tpu_v5e": rec,
        "band_db": BAND_DB,
        "best_vs_record": band(best["mean_psnr"], rec["best_psnr"]),
        "final_vs_record": band(traj.get(final_step), rec["final_psnr"]),
    }
    if run in ("R1", "R5"):
        out["video_frames"] = written_frames(str(ckpt / "video.mp4"))
    out["within_band"] = bool(out["best_vs_record"]["within"]
                              and out["final_vs_record"]["within"])
    return out


def metrics_max(ckpt: Path, key: str, after: int) -> Optional[float]:
    """The largest logged ``key`` after step ``after`` (None if none)."""
    vals = []
    for line in (ckpt / "metrics.jsonl").read_text().splitlines():
        r = json.loads(line)
        if key in r and r["step"] > after:
            vals.append(r[key])
    return max(vals) if vals else None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", default=",".join(RUNS),
                    help="comma-separated runs of " + ", ".join(RUNS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--workdir", default="",
                    help="scenes and checkpoints (default: a temporary "
                         "directory, deleted at the end)")
    ap.add_argument("--out", default="", help="merge each run's section "
                    "into this JSON file (nothing written without it)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    runs = args.runs.split(",")
    unknown = sorted(set(runs) - set(RUNS))
    if unknown:
        raise SystemExit(f"unknown runs {unknown}; choose from {list(RUNS)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run on "
                         "the CPU")
    args.card = card_name(args.device)
    print(args.card, flush=True)
    results = {}
    with tempfile.TemporaryDirectory(prefix="preset_record_") as tmp:
        work = Path(args.workdir or tmp)
        work.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, PATH=os.pathsep.join(
            [str(python_shim_dir(work)), os.environ.get("PATH", "")]))
        if args.out:
            merge_out(args.out, "what", WHAT)
        for run in runs:
            section = run_one(run, args, work, env)
            results[RUNS[run][0]] = section
            print(json.dumps(section), flush=True)
            if args.out:
                merge_out(args.out, RUNS[run][0], section)
    return results


if __name__ == "__main__":
    main()
