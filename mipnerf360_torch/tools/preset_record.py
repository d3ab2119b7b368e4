"""The preset record: the JAX package's validations of its shipping presets
(``PRESET_VALIDATION_r4.json``, ``_r5.json``, taken on a TPU v5e) repeated
through the port's demo scripts and entry points.

    python -m mipnerf360_torch.tools.preset_record --out PRESET_VALIDATION_TORCH.json
    python -m mipnerf360_torch.tools.preset_record --runs R2,R3 --out PATH
    python -m mipnerf360_torch.tools.preset_record --runs R4 --seeds 1,2,3 --out PATH

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
  ``garden_quality_ndc_ablation.ndc_free``;
- R6: ``bicycle_multihost_quality`` as R3 (``mesh.data=-1`` is one device
  here), then ``apps.video --step best`` on the preset's spherified path,
  beside ``bicycle_multihost_quality``; its section says whether it
  equals R3's when ``--out`` holds that;
- R7: ``llff_fern_quality`` as R3 on a forward-facing export (cameras on a
  40-degree arc), then ``apps.video --step best`` on 24 poses of the
  spiral path, beside ``llff_fern_quality_forward_facing``;
- R8: ``garden_quality`` as R3 with ``--set data.use_ndc=True`` (the parity
  presets' NDC path on a 360 capture), beside
  ``garden_quality_ndc_ablation.with_ndc_quirk``: the first logged step
  whose training metrics are not finite, and the trainer's warning;
- R9: R1, then ``apps.train --resume --set train.max_steps=4000`` on its
  checkpoint and ``apps.eval --step best``, beside the 1,500-step run of
  ``PRESET_VALIDATION_r4.json`` and its ``resume_extension``: the logged LR
  after the resume against the schedule anchored at 1,500 steps, the
  largest fall under the eval at the resume step, the restored best step;
- R10: ``blender_lego_quality`` on R2's scene with the preset's own LR
  horizon (``train.lr_max_steps=10000``) cut at 2,200 steps and logged
  every 5, beside the port's ``convergence`` run on the H100
  (``PARITY_PSNR_TORCH.json``, and its break in ``COLLAPSE_TORCH.json``):
  ``train/loss_prop`` at the break step, the image evals at the preset's
  cadence, and the first logged step whose train PSNR differs.

Each run's section holds its commands, the card (``nvidia-smi`` name and
power limit), the trainer's image-PSNR and SSIM trajectory
(``metrics.jsonl``), the final value (the trainer's image eval at the last
step), the ``--step best`` eval (restored step, mean and per-view PSNR and
SSIM), whether the trajectory collapsed (an image eval more than
``COLLAPSE_DB`` under the best before it) and whether ``best`` restored a
model from before that, the first logged step with a non-finite training
metric, the ms per step and the trainer's rays/s (the median of the logged
chunks that follow no image eval), the record beside it, and whether the
best and the final each lie within ``BAND_DB`` of the record's. A video
adds its frame count and each frame's mean and largest luma. ``--seeds``
repeats each run once per seed with ``train.seed`` set, in a section named
``<section>_seed<N>``. ``run_one``'s ``sets`` go to the end of every
command (the demo scripts pass their arguments on): its tests run it at a
smaller size on the CPU. Sections are merged into ``--out``; the scenes and
checkpoints live in a temporary directory unless ``--workdir``. Runs on
the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..apps.video import read_frames
from ..train.schedule import log_lerp_lr
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
# R7: the forward-facing export's arc and the spiral video's poses.
ARC_DEGREES = 40
SPIRAL_POSES = 24
# R9: the resumed run's max_steps.
RESUME_STEPS = 4000
# R10: the preset's LR horizon, the step the run is cut at (after the
# break), its log cadence (the break step is a multiple of it), and the
# break's loss_prop tolerance.
LEGO_LR_STEPS, LEGO_STEPS, LEGO_LOG_EVERY = 10_000, 2200, 5
BREAK_RTOL = 1e-3

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
    "R6": ("bicycle_multihost_quality_2000",
           ("PRESET_VALIDATION_r5.json", "bicycle_multihost_quality")),
    "R7": ("llff_fern_quality_forward_facing_2000",
           ("PRESET_VALIDATION_r5.json", "llff_fern_quality_forward_facing")),
    "R8": ("garden_quality_ndc_2000",
           ("PRESET_VALIDATION_r5.json", "garden_quality_ndc_ablation",
            "with_ndc_quirk")),
    # the 1,500-step run, continued by its resume_extension
    "R9": ("synthetic_quality_resume_4000", ("PRESET_VALIDATION_r4.json",)),
    "R10": ("blender_lego_quality_lr10000_2200",
            ("PARITY_PSNR_TORCH.json", "convergence")),
}
# The runs through a demo script, and those that render a video.
DEMO_RUNS = ("R1", "R5", "R9")
VIDEO_RUNS = ("R1", "R5", "R6", "R7", "R9")
# A run whose training is another's by construction: its section says
# whether it equals that one's in ``--out``.
SAME_AS = {"R6": "R3"}
# The break of convergence seed 0 on the H100 (the spike replay's, repeated
# by the collapse record's self-check).
BREAK_RECORD = ("COLLAPSE_TORCH.json", "self_check", "convergence_seed0")


def _float_keys(d: dict) -> dict:
    return {int(k): float(v) for k, v in d.items()}


def _read(path: str, keys) -> tuple:
    """(the JSON file at ``REPO / path``, its node at the key path)."""
    node = record = json.loads((REPO / path).read_text())
    for k in keys:
        node = node[k]
    return record, node


def _convergence_record() -> dict:
    """R10's record: ``convergence`` seed 0 on the H100 at the preset's eval
    cadence up to the cut, and its break."""
    path, *keys = RUNS["R10"][1]
    _, node = _read(path, keys)
    every = 1000      # blender_lego_quality's eval_image_every
    psnr = {s: v for s, v in _float_keys(node["ours"]["image_psnr"]).items()
            if s % every == 0 and s <= LEGO_STEPS}
    ssim = _float_keys(node["ours"]["image_ssim"])
    best_step = max(psnr, key=psnr.get)
    bpath, *bkeys = BREAK_RECORD
    _, brk = _read(bpath, bkeys)
    return {"source": f"{path} {'.'.join(keys)} (image evals at multiples "
                      f"of {every} up to step {LEGO_STEPS})",
            "hardware": node["card"],
            "trajectory_mean_image_psnr": {s: round(v, 3)
                                           for s, v in psnr.items()},
            "trajectory_psnr_unrounded": psnr,
            "train_psnr_unrounded": _float_keys(node["ours"]["train_psnr"]),
            "best_psnr": round(psnr[best_step], 3),
            "best_ssim": round(ssim[best_step], 4),
            "restored_step": best_step,
            "final_psnr": round(psnr[max(psnr)], 3),
            "break": {"source": f"{bpath} {'.'.join(bkeys)}",
                      "step": brk["step"], "loss_prop": brk["loss_prop"]}}


def record_for(run: str) -> dict:
    """The record a run stands beside: its trajectory, best (PSNR, SSIM,
    restored step where recorded) and final, read from the JAX package's
    record files (TPU v5e), or for R10 from the port's ``convergence`` run
    on the H100."""
    if run == "R10":
        return _convergence_record()
    path, *keys = RUNS[run][1]
    record, node = _read(path, keys)
    hardware = record["hardware"]
    traj = _float_keys(node.get("trajectory_mean_image_psnr", {}))
    if run == "R9":
        traj.update(_float_keys(
            node["resume_extension"]["trajectory_mean_image_psnr"]))
    best = node.get("eval_best_checkpoint", {})
    best_psnr = next((v for k, v in best.items()
                      if k.startswith("mean_psnr")), None)
    best_ssim = next((v for k, v in best.items()
                      if k.startswith("mean_ssim")), None)
    restored = best.get("restored_step")
    if restored is None and isinstance(best.get("restored"), str):
        restored = int(best["restored"].split()[1])
    if best_psnr is None and traj:
        # garden's NDC ablation and the forward-facing run record their
        # trajectories only
        best_psnr = max(traj.values())
    out = {"source": f"{path} {'.'.join(keys)}".strip(), "hardware": hardware,
           "trajectory_mean_image_psnr": traj,
           "best_psnr": best_psnr, "best_ssim": best_ssim,
           "restored_step": restored,
           "final_psnr": traj[max(traj)] if traj else None}
    video = node.get("video_render") or node.get("spiral_video_render")
    if video:
        out["video"] = video
    return out


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


def _records(ckpt: Path) -> list:
    return [json.loads(line)
            for line in (ckpt / "metrics.jsonl").read_text().splitlines()]


def metrics_max(ckpt: Path, key: str, after: int) -> Optional[float]:
    """The largest finite logged ``key`` after step ``after`` (None if
    none)."""
    vals = [r[key] for r in _records(ckpt)
            if key in r and r["step"] > after and math.isfinite(r[key])]
    return max(vals) if vals else None


def first_nonfinite(ckpt: Path) -> Optional[int]:
    """The first logged step with a non-finite ``train/*`` metric."""
    return next((r["step"] for r in _records(ckpt)
                 if any(k.startswith("train/") and not math.isfinite(v)
                        for k, v in r.items())), None)


def frame_luma(frames) -> dict:
    """Each frame's mean and largest luma (ITU-R BT.601 weights on values
    in [0, 1]) and the range of each over the frames."""
    w = np.array([0.299, 0.587, 0.114])
    luma = [np.asarray(f, np.float64)[..., :3] @ w / 255.0 for f in frames]
    means = [round(float(y.mean()), 4) for y in luma]
    maxes = [round(float(y.max()), 4) for y in luma]
    rng = lambda v: [min(v), max(v)] if v else None
    return {"mean_range": rng(means), "max_range": rng(maxes),
            "per_frame_mean": means, "per_frame_max": maxes}


def same_trace(a: dict, b: dict) -> dict:
    """Whether two sections hold the same PSNR and SSIM values (trajectory,
    final, ``--step best`` eval), and the first key where they part."""
    keys = ("trajectory_mean_image_psnr", "trajectory_mean_ssim", "final",
            "eval_best_checkpoint")
    # as the record file holds them: steps as strings
    a, b = (json.loads(json.dumps({k: x.get(k) for k in keys}))
            for x in (a, b))
    first = next((k for k in keys if a[k] != b[k]), None)
    return {"equal": first is None, "first_difference": first}


def _resume_section(ckpt: Path, cfg: dict, traj: dict, restored: int) -> dict:
    """R9: the logged LR after the resume against the schedule anchored at
    the first run's horizon (the logged LR of step S is the one of update
    S - 1), the step it first equals ``lr_final`` from, the LR a horizon
    re-mapped to the new max_steps would give at the first logged step,
    and the evals after the resume against the one at the resume step.
    The warm-up delay (``lr_delay_steps``) keeps the LR under ``lr_final``
    until its end, whatever the horizon."""
    t = cfg["train"]
    recs = _records(ckpt)
    resumed = [r["step"] for r in recs if "data/device_bank" in r][-1]
    lrs = {r["step"]: r["train/lr"] for r in recs
           if "train/lr" in r and r["step"] > resumed}

    def lr(step, horizon):
        return float(log_lerp_lr(step - 1, t["lr_init"], t["lr_final"],
                                 horizon, t["lr_delay_steps"],
                                 t["lr_delay_mult"]))

    # the schedule's floor, lr_final as its float32 arithmetic gives it
    final = lr(max(t["lr_max_steps"], t["lr_delay_steps"]) + 1,
               t["lr_max_steps"])
    from_step = next((s for s in sorted(lrs)
                      if all(lrs[u] == final for u in lrs if u >= s)), None)
    first = min(lrs) if lrs else None
    after = {s: v for s, v in traj.items() if s > resumed}
    at_resume = traj.get(resumed)
    drop = (None if at_resume is None or not after else
            round(at_resume - min(after.values()), 3))
    return {"resumed_from_step": resumed,
            "lr_max_steps": t["lr_max_steps"],
            "lr_after_resume": lrs,
            "lr_matches_anchored_schedule": all(
                v == lr(s, t["lr_max_steps"]) for s, v in lrs.items()),
            "lr_final": final, "lr_final_from_step": from_step,
            "lr_if_remapped_at_first_logged_step": (
                None if first is None else lr(first, t["max_steps"])),
            "eval_at_resume_step": at_resume,
            "largest_fall_under_it_db": drop,
            "no_fall_over_band": None if drop is None else drop <= BAND_DB,
            "best_is_resume_step": restored == resumed}


def _break_section(ckpt: Path, rec: dict, traj_unrounded: dict) -> dict:
    """R10: ``train/loss_prop`` at the break step against the record's,
    the image evals at the record's steps (unrounded, equal or not), and
    the first step both logged whose train PSNR differs."""
    recs = _records(ckpt)
    brk = rec["break"]
    got = next((r["train/loss_prop"] for r in recs
                if r["step"] == brk["step"] and "train/loss_prop" in r), None)
    rel = None if got is None else abs(got - brk["loss_prop"]) / brk["loss_prop"]
    evals = {s: {"ours": traj_unrounded.get(s), "record": v,
                 "equal": traj_unrounded.get(s) == v}
             for s, v in rec["trajectory_psnr_unrounded"].items()}
    ours = {r["step"]: r["train/avg_psnr"] for r in recs
            if "train/avg_psnr" in r}
    theirs = rec["train_psnr_unrounded"]
    shared = sorted(set(ours) & set(theirs))
    differs = next((s for s in shared if ours[s] != theirs[s]), None)
    return {"step": brk["step"], "loss_prop": got,
            "record_loss_prop": brk["loss_prop"],
            "rel_diff": rel, "rtol": BREAK_RTOL,
            "within": None if rel is None else rel <= BREAK_RTOL,
            "image_evals_vs_record": evals,
            "train_psnr_steps_compared": len(shared),
            "first_train_psnr_difference": differs}


def _commands(run: str, work: Path, ckpt: Path, dev: list, sets: list,
              run_env: dict) -> list:
    """The run's commands, its scene exported first."""
    eval_every = ["--set", f"train.eval_image_every={EVAL_EVERY}"]
    blender = run in ("R2", "R10")
    arc = run == "R7"
    scene = work / (f"blender_{RES}" if blender else
                    f"llff_arc{ARC_DEGREES}_{RES}" if arc else f"llff_{RES}")
    if run not in ("R1", "R9") and not scene.exists():
        if blender:
            export_blender_scene(str(scene), RES)
        else:
            export_llff_scene(str(scene), RES, n_views=32,
                              arc_degrees=ARC_DEGREES if arc else None)
    evaluate = [sys.executable, "-m", f"{APPS}.eval", "--ckpt", str(ckpt),
                "--step", "best", *dev, *sets]
    video = [sys.executable, "-m", f"{APPS}.video", "--ckpt", str(ckpt),
             "--step", "best", *dev]
    if run == "R1":
        return [["bash", str(DEMO / "demo_synthetic.sh"), *sets]]
    if run == "R9":
        return [["bash", str(DEMO / "demo_synthetic.sh"), *sets],
                [sys.executable, "-m", f"{APPS}.train", "--preset",
                 "synthetic_quality", "--resume", "--set",
                 f"train.max_steps={RESUME_STEPS}", "--set",
                 f"train.checkpoint_dir={ckpt}", *dev, *sets],
                evaluate]
    if run == "R5":
        run_env["DATA"] = str(scene)
        return [["bash", str(DEMO / "demo_360.sh"), "--set", "data.factor=1",
                 "--set", "train.max_steps=2000", *eval_every, *sets]]
    preset = {"R2": "blender_lego_quality", "R6": "bicycle_multihost_quality",
              "R8": "garden_quality", "R10": "blender_lego_quality"}.get(
                  run, "llff_fern_quality")
    steps = {"R4": [],
             "R8": ["--set", "data.use_ndc=True", "--set",
                    "train.max_steps=2000", *eval_every],
             "R10": ["--set", f"train.lr_max_steps={LEGO_LR_STEPS}", "--set",
                     f"train.max_steps={LEGO_STEPS}", "--set",
                     f"train.log_every={LEGO_LOG_EVERY}"]}.get(
                         run, ["--set", "train.max_steps=2000", *eval_every])
    train = [sys.executable, "-m", f"{APPS}.train", "--preset", preset,
             "--set", f"data.base_dir={scene}", "--set", "data.factor=1",
             *steps, "--set", f"train.checkpoint_dir={ckpt}", *dev, *sets]
    if run == "R8":
        # the NDC path may leave no finite eval, and then no best
        # checkpoint: run_one evaluates only when there is one
        return [train]
    if run == "R6":
        return [train, evaluate, [*video, *sets]]
    if run == "R7":
        return [train, evaluate,
                [*video, "--set", f"data.n_render_poses={SPIRAL_POSES}",
                 *sets]]
    return [train, evaluate]


def run_one(run: str, args, work: Path, env: dict, sets=()) -> dict:
    """Train, eval (and where the run has one, the video) one run; its
    section. ``sets`` (``K=V`` config overrides) go to the end of every
    command."""
    name = RUNS[run][0]
    ckpt = work / name
    log = work / f"{name}.log"
    sets = [x for s in sets for x in ("--set", s)]
    dev = ["--device", args.device]
    run_env = dict(env, DEVICE=args.device, CKPT=str(ckpt))
    cmds = _commands(run, work, ckpt, dev, sets, run_env)
    t0 = time.time()
    for cmd in cmds:
        print(f"{run}: {' '.join(cmd)}", flush=True)
        _run(cmd, log, run_env)
    if run == "R8" and any(ckpt.glob("ckpt_best.*")):
        cmds.append([sys.executable, "-m", f"{APPS}.eval", "--ckpt",
                     str(ckpt), "--step", "best", *dev, *sets])
        print(f"{run}: {' '.join(cmds[-1])}", flush=True)
        _run(cmds[-1], log, run_env)
    wall = time.time() - t0

    cfg = json.loads((ckpt / "config.json").read_text())
    metrics = parse_ours_metrics(str(ckpt))
    traj = {int(k): round(v, 3) for k, v in metrics["image_psnr"].items()}
    ssim = {int(k): round(v, 4) for k, v in metrics["image_ssim"].items()}
    eval_json = ckpt / "test" / "eval.json"
    best = json.loads(eval_json.read_text()) if eval_json.exists() else None
    restored = None if best is None else best["step"]
    final_step = max(traj) if traj else None
    rec = record_for(run)
    loss_prop = metrics_max(ckpt, "train/loss_prop", after=EVAL_EVERY)
    ms = ms_per_step(str(ckpt))
    out = {
        "run": run,
        "commands": [shown(c) for c in cmds],
        "env": {k: run_env[k] for k in ("DEVICE", "CKPT", "DATA")
                if k in run_env and run in DEMO_RUNS},
        "card": args.card,
        "torch": f"{torch.__version__} cuda {torch.version.cuda}",
        "steps": cfg["train"]["max_steps"],
        "batch": cfg["train"]["batch_size"],
        "trajectory_mean_image_psnr": traj,
        "trajectory_mean_ssim": ssim,
        "final": {"step": final_step,
                  "mean_psnr": traj.get(final_step),
                  "mean_ssim": ssim.get(final_step)},
        "eval_best_checkpoint": None if best is None else {
            "restored_step": best["step"], "n_views": best["n_views"],
            "mean_psnr": round(best["mean_psnr"], 3),
            "mean_ssim": (round(best["mean_ssim"], 4)
                          if "mean_ssim" in best else None),
            "per_view_psnr": [round(p, 2) for p in best["per_view_psnr"]]},
        "collapse": dict(collapse(traj, restored),
                         max_train_loss_prop_after_first_eval=loss_prop),
        "first_nonfinite_step": first_nonfinite(ckpt),
        "ms_per_step": None if ms is None else round(ms, 3),
        "trainer_rays_per_sec": (None if ms is None else
                                 round(cfg["train"]["batch_size"] * 1e3 / ms,
                                       1)),
        "wall_s": round(wall, 1),
        ("record_convergence_h100" if run == "R10" else "record_tpu_v5e"):
            {k: v for k, v in rec.items() if not k.endswith("_unrounded")},
        "band_db": BAND_DB,
        "best_vs_record": band(None if best is None else best["mean_psnr"],
                               rec["best_psnr"]),
        "final_vs_record": band(traj.get(final_step), rec["final_psnr"]),
    }
    if run in VIDEO_RUNS:
        frames = read_frames(str(ckpt / "video.mp4"))
        out["video_frames"] = len(frames)
        out["video_luma"] = frame_luma(frames)
    if run == "R8":
        warned = re.search(r"\[warn\] non-finite training metrics at step "
                           r"(\d+)", log.read_text())
        out["nonfinite_warning_step"] = (None if warned is None
                                         else int(warned.group(1)))
        out["check_nans"] = cfg["train"]["check_nans"]
    if run == "R9":
        out["resume"] = _resume_section(ckpt, cfg, traj, restored)
    if run == "R10":
        out["break"] = _break_section(
            ckpt, rec, {int(k): v for k, v in metrics["image_psnr"].items()})
    out["within_band"] = bool(out["best_vs_record"]["within"]
                              and out["final_vs_record"]["within"])
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", default=",".join(RUNS),
                    help="comma-separated runs of " + ", ".join(RUNS))
    ap.add_argument("--seeds", default="",
                    help="comma-separated train.seed values: each run once "
                         "per seed, in sections <section>_seed<N> (default: "
                         "the presets' own seed, sections as named)")
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
    seeds = [int(s) for s in args.seeds.split(",")] if args.seeds else [None]
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run on "
                         "the CPU")
    args.card = card_name(args.device)
    print(args.card, flush=True)
    results = {}
    with tempfile.TemporaryDirectory(prefix="preset_record_") as tmp:
        root = Path(args.workdir or tmp)
        if args.out:
            merge_out(args.out, "what", WHAT)
        for seed in seeds:
            work = root if seed is None else root / f"seed{seed}"
            work.mkdir(parents=True, exist_ok=True)
            env = dict(os.environ, PATH=os.pathsep.join(
                [str(python_shim_dir(work)), os.environ.get("PATH", "")]))
            suffix = "" if seed is None else f"_seed{seed}"
            for run in runs:
                if seed is None:
                    section = run_one(run, args, work, env)
                else:
                    section = run_one(run, args, work, env,
                                      sets=(f"train.seed={seed}",))
                    section["seed"] = seed
                other = SAME_AS.get(run)
                if other and args.out and os.path.exists(args.out):
                    theirs = json.loads(Path(args.out).read_text()).get(
                        RUNS[other][0] + suffix)
                    if theirs is not None:
                        section[f"vs_{other}"] = same_trace(section, theirs)
                key = RUNS[run][0] + suffix
                results[key] = section
                print(json.dumps(section), flush=True)
                if args.out:
                    merge_out(args.out, key, section)
    return results


if __name__ == "__main__":
    main()
