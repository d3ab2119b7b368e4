"""The quality record: PSNR at equal iterations against the reference, and
convergence at the flagship operating point (counterpart of the training
modes of the JAX package's ``tools/parity_psnr.py``).

    python -m mipnerf360_torch.tools.parity_psnr --mode convergence [--steps 10000 --batch 4096]
    python -m mipnerf360_torch.tools.parity_psnr --mode quality-equal-batch|parity|ablate [--steps 1000]
    python -m mipnerf360_torch.tools.parity_psnr --mode convergence --device cpu --steps 10 --batch 64 --res 8
    ... --out PATH

Every mode exports the procedural sphere as a Blender-format scene (28
train and 4 interleaved held-out views of ``--res`` pixels, alpha 255),
trains this package on it and builds one section, keyed and shaped as the
JAX tool's section of ``PARITY_PSNR.json``:

- ``convergence`` (section ``convergence``): the quality model, joint
  cadence, ``--batch`` rays, a full held-out-image eval every
  ``max(10, steps // 100)`` steps; then the final and the best checkpoint
  re-evaluated over all held-out views.
- ``quality-equal-batch`` (``quality_equal_batch``): the quality model at the
  reference's operating point (batch 64, reference 2+1 cadence).
- ``parity`` (``parity``): the parity model at the same operating point,
  with the tail means and the ``ge`` fractions against the reference.
- ``ablate`` (``train_psnr_ablation``): the parity run with the reference's
  two fixed bugs reinstated one at a time (``resample_u_typo``,
  ``quirk_collapsed_bounds``), each with :func:`train_psnr_probe`.

The reference side is never run here: it is the recorded run in
``--record`` (default ``PARITY_PSNR.json``, read only; its ``parity``
section holds the reference's trajectories and the image eval of its own
checkpoints). ``parity`` therefore refuses a ``--steps``/``--res`` pair
other than the record's. Each section also carries ``card``, the
``nvidia-smi --query-gpu=name,power.limit`` line ("cpu" with ``--device
cpu``), and the wall seconds of each run. Sections are merged into
``--out PATH`` (never ``PARITY_PSNR.json``); without it nothing is written
into the repo, and the scene and checkpoints live in a temporary directory
unless ``--scene-dir``/``--workdir`` are given. Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..config import QUALITY_MODEL, QUALITY_TRAIN, get_config
from ..core.rays import rays_to_device, resolve_device
from ..data import get_dataset
from ..data.rays_gen import pinhole_rays
from ..data.synthetic import _orbit_poses_at, _shade_sphere, _train_angles
from ..losses.photometric import photometric_loss
from ..models.mipnerf360 import render_rays
from ..train.checkpoint import restore_checkpoint
from ..train.state import init_train_state
from ..train.trainer import evaluate_images, train
from ..utils.png import save_png
from .bench import card_name

REPO = Path(__file__).resolve().parents[2]
RECORD = REPO / "PARITY_PSNR.json"
SCENE = {"train_views": 28, "test_views": 4,
         "holdout": "interleaved every-8th"}
SECTIONS = {"parity": "parity", "convergence": "convergence",
            "ablate": "train_psnr_ablation",
            "quality-equal-batch": "quality_equal_batch"}
ABLATE_VARIANTS = {
    "base": ({}, {}),
    "u_typo": ({"resample_u_typo": True}, {}),
    "collapsed_bounds": ({}, {"quirk_collapsed_bounds": True}),
    "both": ({"resample_u_typo": True}, {"quirk_collapsed_bounds": True}),
}


def _to_u8(rgb: np.ndarray) -> np.ndarray:
    return np.clip(rgb * 255 + 0.5, 0, 255).astype(np.uint8)


def export_blender_scene(out_dir: str, res: int, n_train: int = 28,
                         n_test: int = 4):
    """The procedural sphere as a Blender-format scene: RGBA PNGs with alpha
    255 everywhere (white background baked in), ``transforms_*.json`` for
    the train, test and visualize splits. The holdout interleaves (every
    ``n_total / n_test``-th view, the reference's every-8th LLFF
    convention), so eval measures view synthesis, not extrapolation; the
    visualize split mirrors test under the name the reference renders."""
    focal = 0.9 * res
    angle_x = 2.0 * np.arctan(0.5 * res / focal)
    n_total = n_train + n_test
    all_poses = _orbit_poses_at(_train_angles(n_total))
    test_idx = set(np.linspace(0, n_total, n_test,
                               endpoint=False).astype(int).tolist())
    train_idx = [i for i in range(n_total) if i not in test_idx]
    splits = {"train": all_poses[train_idx],
              "test": all_poses[sorted(test_idx)],
              "visualize": all_poses[sorted(test_idx)]}
    for split, poses in splits.items():
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        rays = pinhole_rays(poses, res, res, focal, 2.0, 6.0)
        rgb = _shade_sphere(rays.origins, rays.viewdirs)   # [P, H, W, 3]
        frames = []
        for i in range(len(poses)):
            img = np.concatenate([_to_u8(rgb[i]),
                                  np.full((res, res, 1), 255, np.uint8)], -1)
            save_png(os.path.join(out_dir, split, f"r_{i}.png"), img)
            c2w = np.eye(4, dtype=np.float64)
            c2w[:3, :4] = poses[i]
            frames.append({"file_path": f"{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": float(angle_x), "frames": frames}, f)
    return out_dir


def export_llff_scene(out_dir: str, res: int = 64, n_views: int = 32,
                      arc_degrees: float = None):
    """The procedural sphere as an LLFF-format scene: ``images/`` and
    ``poses_bounds.npy``, each row a flattened 3x5 matrix (rotation columns
    [down, right, back], position, [h, w, focal]) and the metric [near, far]
    bounds [d - 1.3, d + 2.0] for camera distance d. The background is black
    (the llff/nerf_360 regime trains with white_bkgd=False). ``arc_degrees``
    None is a full 360 orbit; a value restricts the cameras to that azimuth
    arc, a forward-facing capture."""
    focal = 0.9 * res
    if arc_degrees is None:
        angles = _train_angles(n_views)
    else:
        half = np.deg2rad(arc_degrees) / 2.0
        angles = np.linspace(-half, half, n_views)
    poses = _orbit_poses_at(angles)                   # [N, 3, 4]
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    rays = pinhole_rays(poses, res, res, focal, 2.0, 6.0)
    rgb = _shade_sphere(rays.origins, rays.viewdirs, background=0.0)
    rows = []
    for i in range(n_views):
        save_png(os.path.join(img_dir, f"image{i:03d}.png"), _to_u8(rgb[i]))
        right, up, back, t = (poses[i][:, j] for j in range(4))
        disk = np.stack([-up, right, back, t,
                         np.array([res, res, focal], np.float64)], axis=1)
        d = float(np.linalg.norm(t))
        rows.append(np.concatenate([disk.reshape(-1), [d - 1.3, d + 2.0]]))
    np.save(os.path.join(out_dir, "poses_bounds.npy"),
            np.asarray(rows, np.float64))
    return out_dir


def _ours_cfg(scene_dir: str, steps: int, ckpt_dir: str, *,
              cadence: str = "reference", batch_size: int = 64,
              eval_image_every: int = 0, quality: bool = False,
              extra_model: dict = None, extra_train: dict = None):
    """The run's Config: white background, the QUALITY_MODEL/QUALITY_TRAIN
    overrides when ``quality`` (the synthetic_quality preset's values),
    logs and batch evals every 10 steps, no periodic save (the trainer's
    final save and ``keep_best`` remain), the exported scene at near 2, far
    6. ``extra_model``/``extra_train`` go over everything else."""
    model = dict(white_bkgd=True)
    train_over = {}
    if quality:
        model.update(QUALITY_MODEL)
        train_over = dict(QUALITY_TRAIN)
    model.update(extra_model or {})
    train_over.update(extra_train or {})
    train_cfg = dict(max_steps=steps, batch_size=batch_size, cadence=cadence,
                     log_every=10, eval_every=10, save_every=0,
                     eval_image_every=eval_image_every,
                     checkpoint_dir=ckpt_dir)
    train_cfg.update(train_over)
    return get_config(
        model=model, train=train_cfg,
        data=dict(dataset="blender", base_dir=scene_dir, factor=1,
                  near=2.0, far=6.0))


def _restore(cfg, which, device):
    template = init_train_state(cfg.model, cfg.train, device=device)
    return restore_checkpoint(cfg.train.checkpoint_dir, template, step=which)


def eval_checkpoint_views(cfg, which, device="cuda") -> dict:
    """Mean and per-view PSNR/SSIM of a saved checkpoint over ALL test
    views. ``which``: a step, a name such as "best", or None (latest)."""
    device = resolve_device(device)
    state = _restore(cfg, which, device)
    test = get_dataset(cfg.data, "test", white_bkgd=cfg.model.white_bkgd)
    out = evaluate_images(cfg, state.params, test, device=device)
    out["step"] = int(state.step)
    return out


def train_psnr_probe(cfg, n_batches: int = 8, device="cuda") -> dict:
    """The train-batch PSNR at the latest checkpoint with stochastic
    sampling on (what ``train/avg_psnr`` measures) and off (the model's
    fit), over ``n_batches`` train batches of the stream seeded
    ``seed + 2``; batch i's noise comes from a generator seeded ``100 + i``
    on ``device``. A large gap would mean the logged train PSNR
    under-reports the fit because of sampling noise."""
    device = resolve_device(device)
    state = _restore(cfg, None, device)
    ds = get_dataset(cfg.data, "train", white_bkgd=cfg.model.white_bkgd)
    batches = ds.batches(cfg.train.batch_size, seed=cfg.train.seed + 2)
    psnrs = {True: [], False: []}
    with torch.inference_mode():
        for i in range(n_batches):
            rays_np, pix_np = next(batches)
            rays = rays_to_device(rays_np, device)
            pixels = torch.as_tensor(pix_np, device=device)
            for randomized, acc in psnrs.items():
                gen = torch.Generator(device).manual_seed(100 + i)
                out = render_rays(state.params, cfg.model, rays, randomized,
                                  generator=gen)
                acc.append(float(photometric_loss(out["rgb"], pixels)[1]))
    return {"train_psnr_randomized": round(float(np.mean(psnrs[True])), 3),
            "train_psnr_deterministic": round(float(np.mean(psnrs[False])), 3),
            "n_batches": n_batches}


def parse_ours_metrics(ckpt_dir: str) -> dict:
    """{train_psnr, eval_psnr, image_psnr, image_ssim}, each {step: value},
    from the trainer's ``metrics.jsonl``."""
    train_psnr, eval_psnr = {}, {}
    image_psnr, image_ssim = {}, {}
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "train/avg_psnr" in rec:
                train_psnr[rec["step"]] = rec["train/avg_psnr"]
            # the JAX package's runs before its r5 logged "eval/psnr"
            for k in ("eval/psnr_batch_noisy", "eval/psnr"):
                if k in rec:
                    eval_psnr[rec["step"]] = rec[k]
                    break
            if "eval/psnr_image" in rec:
                image_psnr[rec["step"]] = rec["eval/psnr_image"]
            if "eval/ssim" in rec:
                image_ssim[rec["step"]] = rec["eval/ssim"]
    return {"train_psnr": train_psnr, "eval_psnr": eval_psnr,
            "image_psnr": image_psnr, "image_ssim": image_ssim}


def ms_per_step(ckpt_dir: str):
    """Median ms per train step over the logged chunks after the first
    (``perf/steps_per_sec``: a chunk's steps and its batch eval), leaving
    out each chunk that follows an image eval; None with one chunk."""
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    image_evals = {r["step"] for r in recs if "eval/psnr_image" in r}
    chunks = [r for r in recs if "perf/steps_per_sec" in r]
    rates = [b["perf/steps_per_sec"] for a, b in zip(chunks, chunks[1:])
             if a["step"] not in image_evals]
    return 1e3 / statistics.median(rates) if rates else None


def run_ours(scene_dir: str, steps: int, ckpt_dir: str, *,
             cadence: str = "reference", batch_size: int = 64,
             eval_image_every: int = 0, quality: bool = False,
             extra_model: dict = None, extra_train: dict = None,
             reuse: bool = False, device="cuda"):
    """Train on ``device`` into a fresh ``ckpt_dir`` (or, with ``reuse``,
    parse an EXISTING run's metrics) and return the trajectories and the
    wall seconds."""
    cfg = _ours_cfg(scene_dir, steps, ckpt_dir, cadence=cadence,
                    batch_size=batch_size, eval_image_every=eval_image_every,
                    quality=quality, extra_model=extra_model,
                    extra_train=extra_train)
    wall = 0.0
    if not reuse:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        t0 = time.time()
        train(cfg, device=device)
        wall = time.time() - t0
        ms = ms_per_step(ckpt_dir)
        print(f"trained {steps} steps ({cadence} cadence, batch "
              f"{batch_size}) in {wall:.1f} s; "
              f"{'n/a' if ms is None else f'{ms:.3f}'} ms per step (median "
              f"of the logged chunks) -> {ckpt_dir}", flush=True)
    out = parse_ours_metrics(ckpt_dir)
    out["wall_s"] = round(wall, 1)
    return out


def last(d: dict):
    return d[max(d)] if d else None


def tail_mean(d: dict, frac: float = 0.2):
    """Mean over the final ``frac`` of the logged trajectory. A single
    64-ray batch PSNR is noisy (~4 dB std on this scene in the JAX
    package's runs), so tail means, not single points, are compared."""
    if not d:
        return None
    ss = sorted(d)
    tail = [d[s] for s in ss[int(len(ss) * (1 - frac)):]]
    return {"mean": round(float(np.mean(tail)), 3),
            "std": round(float(np.std(tail)), 3),
            "n_points": len(tail)}


def ge_frac(ours: dict, ref: dict, steps) -> float:
    """The fraction of ``steps`` at which ours >= the reference, to 4
    places; None without shared steps."""
    if not steps:
        return None
    return round(float(np.mean([ours[s] >= ref[s] for s in steps])), 4)


def _int_keys(d: dict) -> dict:
    return {int(k): v for k, v in d.items()}


def merge_out(path, key: str, section: dict) -> None:
    """Read-modify-write ``path`` so that runs of separate modes each add
    their section."""
    result = {}
    if os.path.exists(path):
        with open(path) as f:
            result = json.load(f)
    result[key] = section
    with open(path, "w") as f:
        json.dump(result, f, indent=2)


def ablate(args, kw_over) -> dict:
    """The parity run with the reference's two fixed bugs reinstated one at
    a time, each with :func:`train_psnr_probe` at its final checkpoint."""
    section = {
        "steps": args.steps,
        "what": ("Reference-cadence batch-64 runs with the reference's "
                 "two fixed bugs reinstated one at a time; plus a probe "
                 "separating stochastic-sampling noise in the train-PSNR "
                 "METRIC from actual model fit (train_psnr_deterministic)."),
        "variants": {},
    }
    for name, (m_extra, t_extra) in ABLATE_VARIANTS.items():
        ckpt_dir = os.path.join(args.workdir, f"ablate_{name}")
        kw = dict(cadence="reference", batch_size=64,
                  eval_image_every=max(10, args.steps // 4),
                  **kw_over(m_extra, t_extra))
        ours = run_ours(args.scene_dir, args.steps, ckpt_dir,
                        device=args.device, **kw)
        cfg = _ours_cfg(args.scene_dir, args.steps, ckpt_dir, **kw)
        section["variants"][name] = {
            "final_train_psnr": last(ours["train_psnr"]),
            "final_eval_psnr": last(ours["eval_psnr"]),
            "final_image_psnr": last(ours["image_psnr"]),
            "probe": train_psnr_probe(cfg, device=args.device),
            "wall_s": ours["wall_s"],
        }
        print(f"[ablate] {name}: {section['variants'][name]}", flush=True)
    probes = {n: v["probe"]["train_psnr_randomized"]
              for n, v in section["variants"].items()}
    det_delta = max(abs(v["probe"]["train_psnr_randomized"]
                        - v["probe"]["train_psnr_deterministic"])
                    for v in section["variants"].values())
    section["conclusion"] = (
        "Reinstating the reference's two fixed bugs moves the 8-batch "
        f"probe mean by {max(probes.values()) - min(probes.values()):.3f} "
        f"dB ({probes}); stochastic sampling moves it by at most "
        f"{det_delta:.3f} dB (randomized against deterministic probe).")
    section["hardware"] = f"ours on {args.card}; no reference run"
    return section


def quality_equal_batch(args, kw_over, record: dict) -> dict:
    """The quality model at the reference's operating point (batch 64, 2+1
    cadence), against the reference's image PSNRs in the record."""
    ckpt_dir = os.path.join(args.workdir, "ours_ckpt_qeb")
    ours = run_ours(args.scene_dir, args.steps, ckpt_dir, cadence="reference",
                    batch_size=64, eval_image_every=max(10, args.steps // 4),
                    quality=True, device=args.device, **kw_over({}, {}))
    ref_images = {int(k): v["reference"] for k, v in
                  record.get("parity", {}).get("summary", {}).get(
                      "image_psnr_at_shared_checkpoints", {}).items()}
    shared = sorted(set(ours["image_psnr"]) & set(ref_images))
    return {
        "steps": args.steps,
        "what": ("QUALITY model at the reference's exact operating "
                 "point: batch 64 (equal rays/iteration), reference "
                 "2+1 cadence, shared exported scene. Reference image "
                 "PSNRs from the recorded 'parity' section of "
                 f"{os.path.basename(args.record)} (its own pipeline "
                 "rendered its own checkpoints)."),
        "rays_per_iteration": "equal (64 both sides)",
        "image_psnr_at_shared_checkpoints": {
            s: {"ours_quality": ours["image_psnr"][s],
                "reference": ref_images[s]} for s in shared},
        "ours_ge_ref_frac": ge_frac(ours["image_psnr"], ref_images, shared),
        "final_image_ssim": last(ours["image_ssim"]),
        "wall_s": ours["wall_s"],
    }


def convergence(args, kw_over) -> dict:
    """The quality model at the flagship operating point, then its final
    and best checkpoints over all held-out views."""
    ckpt_dir = os.path.join(args.workdir, "ours_ckpt_conv")
    kw = dict(cadence="joint", batch_size=args.batch,
              eval_image_every=max(10, args.steps // 100), quality=True,
              **kw_over({}, {}))
    ours = run_ours(args.scene_dir, args.steps, ckpt_dir, device=args.device,
                    **kw)
    ours["cadence"] = (f"joint, batch {args.batch}, seed {args.seed}, "
                       "quality config "
                       "(config.py QUALITY_MODEL/QUALITY_TRAIN — the "
                       "garden_quality/synthetic_quality preset values)")
    cfg = _ours_cfg(args.scene_dir, args.steps, ckpt_dir, **kw)
    final_eval = eval_checkpoint_views(cfg, None, args.device)
    try:
        best_eval = eval_checkpoint_views(cfg, "best", args.device)
    except FileNotFoundError:
        best_eval = None
    imgs = ours["image_psnr"]
    return {
        "steps": args.steps,
        "scene": {"res": args.res, **SCENE},
        "note": ("eval image_psnr/image_ssim are the MEAN over all 4 "
                 "held-out views per boundary (trainer eval_image_every, "
                 "eval_image_views=-1); eval_psnr is the 64-ray batch eval "
                 "kept for cadence parity with the reference. final/best "
                 "checkpoint rows re-evaluate all views from the saved "
                 "checkpoints."),
        "ours": ours,
        "summary": {
            "final_checkpoint": final_eval,
            "best_checkpoint": best_eval,
            "trajectory_final_image_psnr": last(imgs),
            "trajectory_max_image_psnr": max(imgs.values()) if imgs else None,
        },
    }


def parity(args, kw_over, record: dict) -> dict:
    """The parity model at the reference's operating point, against the
    recorded reference run of the same steps and resolution."""
    rec = record.get("parity", {})
    if "reference" not in rec:
        raise SystemExit(f"{args.record} holds no recorded parity reference")
    if (args.steps, args.res) != (rec["steps"], rec["scene"]["res"]):
        raise SystemExit(
            f"--steps {args.steps} --res {args.res}: the recorded reference "
            f"ran {rec['steps']} steps at res {rec['scene']['res']}, and "
            "the reference is not run here")
    ours = run_ours(args.scene_dir, args.steps,
                    args.reuse_ours or os.path.join(args.workdir, "ours_ckpt"),
                    eval_image_every=max(10, args.steps // 20),
                    reuse=bool(args.reuse_ours), device=args.device,
                    **kw_over({}, {}))
    ours["cadence"] = "reference (2 prop + 1 nerf updates/step, batch 64)"
    if args.reuse_ours:
        ours["reused_from"] = args.reuse_ours
    reference = rec["reference"]
    ref_train = _int_keys(reference["train_psnr"])
    ref_eval = _int_keys(reference["eval_psnr"])
    ref_images = _int_keys(reference["image_eval"])
    ref_image_psnr = {s: v["image_psnr"] for s, v in ref_images.items()}
    # eval PSNR at every step both sides logged; image PSNR at the
    # reference's saved checkpoints (its model_<N>.pt holds N+1 updates
    # against our N: a one-step offset in the reference's favour)
    shared = sorted(set(ours["eval_psnr"]) & set(ref_eval))
    shared_img = sorted(set(ours["image_psnr"]) & set(ref_images))
    final_ref = ref_images[max(ref_images)] if ref_images else {}
    return {
        "steps": args.steps,
        "scene": {"res": args.res, **SCENE},
        "note": ("train_psnr is the instantaneous per-step batch PSNR on "
                 "both sides; eval_psnr is one 64-ray holdout batch. The "
                 "reference side is the recorded run from "
                 f"{os.path.basename(args.record)}, not run here. "
                 "Wall-clock is NOT a throughput benchmark (batch 64, "
                 "reference cadence); see mipnerf360_torch.tools.bench."),
        "ours": ours,
        "reference": reference,
        "summary": {
            "final_train_psnr": {"ours": last(ours["train_psnr"]),
                                 "reference": last(ref_train)},
            "train_psnr_tail_mean": {"ours": tail_mean(ours["train_psnr"]),
                                     "reference": tail_mean(ref_train)},
            "final_eval_psnr": {"ours": last(ours["eval_psnr"]),
                                "reference": last(ref_eval)},
            "final_image_psnr": {"ours": last(ours["image_psnr"]),
                                 "reference": final_ref.get("image_psnr")},
            "final_image_ssim": {"ours": last(ours["image_ssim"]),
                                 "reference": final_ref.get("image_ssim")},
            "shared_eval_checkpoints": len(shared),
            "ours_ge_ref_at_checkpoint_frac": ge_frac(
                ours["eval_psnr"], ref_eval, shared),
            "image_psnr_at_shared_checkpoints": {
                s: {"ours": ours["image_psnr"][s],
                    "reference": ref_image_psnr[s]} for s in shared_img},
            "ours_ge_ref_image_frac": ge_frac(
                ours["image_psnr"], ref_image_psnr, shared_img),
        },
    }


def run(args, base_model: dict = None, base_train: dict = None) -> dict:
    """Export the scene, run ``args.mode`` and return its section (also
    merged into ``args.out`` when given). ``base_model``/``base_train``
    override fields of every run's model and train config, over the
    mode's own (a tiny model for tests, or cadences for a short run)."""
    if args.out and Path(args.out).resolve() in (RECORD,
                                                 Path(args.record).resolve()):
        raise SystemExit(f"--out {args.out}: that is the recorded run, which "
                         "is never written here")
    args.device = resolve_device(args.device)
    args.card = card_name(args.device)
    print(f"parity_psnr --mode {args.mode} on {args.card}", flush=True)

    def kw_over(m_extra: dict, t_extra: dict) -> dict:
        return {"extra_model": {**m_extra, **(base_model or {})},
                "extra_train": {**t_extra, "seed": args.seed,
                                **(base_train or {})}}

    record = None
    if args.mode in ("parity", "quality-equal-batch"):
        with open(args.record) as f:
            record = json.load(f)
    with tempfile.TemporaryDirectory(prefix="parity_psnr_") as tmp:
        args.scene_dir = args.scene_dir or os.path.join(tmp, "scene")
        args.workdir = args.workdir or os.path.join(tmp, "work")
        export_blender_scene(args.scene_dir, args.res)
        print(f"exported scene to {args.scene_dir}", flush=True)
        if args.mode == "ablate":
            section = ablate(args, kw_over)
        elif args.mode == "quality-equal-batch":
            section = quality_equal_batch(args, kw_over, record)
        elif args.mode == "convergence":
            section = convergence(args, kw_over)
        else:
            section = parity(args, kw_over, record)
    section["card"] = args.card
    if args.out:
        merge_out(args.out, SECTIONS[args.mode], section)
    print(json.dumps(section.get("summary", section), indent=2), flush=True)
    return section


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=list(SECTIONS), default="parity")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4096,
                    help="convergence-mode ray batch (the other modes use "
                         "the reference's 64)")
    ap.add_argument("--scene-dir", default="",
                    help="where the scene is exported (default: a temporary "
                         "directory, deleted at the end)")
    ap.add_argument("--workdir", default="",
                    help="where checkpoints and metrics go (default: a "
                         "temporary directory, deleted at the end)")
    ap.add_argument("--reuse-ours", default="",
                    help="parity mode: parse this EXISTING checkpoint dir's "
                         "metrics.jsonl (a run of the identical config) "
                         "instead of training")
    ap.add_argument("--seed", type=int, default=0,
                    help="train.seed of every run: the init, the batch "
                         "stream and the sampling noise (the JAX tool's "
                         "runs all take 0)")
    ap.add_argument("--record", default=str(RECORD),
                    help="the recorded reference run (read only)")
    ap.add_argument("--out", default="",
                    help="merge the section into this JSON file")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; cpu for the CPU)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
