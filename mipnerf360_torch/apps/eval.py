"""Holdout-view evaluation CLI (counterpart of ``mipnerf360_tpu/apps/eval.py``).

Renders every held-out view, writes rgb (+ optional depth/normal) PNGs, and
reports per-image and mean PSNR (per-pixel mean squared error), SSIM, and
with ``--lpips <weights.npz>`` LPIPS, with ``eval.json`` beside the PNGs.
Reads the port's checkpoints and the JAX package's. Under torchrun with
more than one rank every rank renders its share of each view and rank 0
writes the PNGs and ``eval.json``.

    python -m mipnerf360_torch.apps.eval --ckpt ckpt/ [--device cpu]
    torchrun --nproc_per_node=N -m mipnerf360_torch.apps.eval --ckpt ckpt/
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..core.rays import rays_to_device
from ..data import get_dataset
from ..data.viz import to8b, visualize_depth, visualize_normals
from ..models.mipnerf360 import render_image
from ..parallel.mesh import is_primary
from ..train.checkpoint import restore_checkpoint
from ..train.state import init_train_state
from ..train.trainer import BackgroundStager
from ..utils import metrics
from ..utils.lpips import load_weights, lpips
from ..utils.png import save_png
from .common import add_config_args, config_from_args, render_setup


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None) and evaluate; returns the
    ``eval.json`` summary (None when the split has no ground truth)."""
    ap = argparse.ArgumentParser(description=__doc__)
    add_config_args(ap)
    ap.add_argument("--ckpt", default="", help="checkpoint dir (default: cfg)")
    ap.add_argument("--step", default=None,
                    type=lambda s: int(s) if s.isdigit() else s,
                    help="checkpoint step to load (default: latest), or "
                         "'best' for the best-eval checkpoint kept by the "
                         "trainer")
    ap.add_argument("--out", default="", help="output dir (default: ckpt/test)")
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--depth", action="store_true", help="write depth viz")
    ap.add_argument("--normals", action="store_true", help="write normal viz")
    ap.add_argument("--lpips", default="",
                    help="path to lpips_vgg.npz (the JAX package's "
                         "tools/export_lpips_weights.py writes it). LPIPS "
                         "needs pretrained VGG weights, which the repo does "
                         "not ship; without the file only PSNR/SSIM are "
                         "reported.")
    args = ap.parse_args(argv)

    # Resolve the checkpoint dir first, so that its saved config.json
    # supplies the model without re-typing --set.
    pre = config_from_args(args)
    ckpt_dir = args.ckpt or pre.train.checkpoint_dir
    cfg = config_from_args(args, ckpt_dir=ckpt_dir)
    with render_setup(args, cfg) as (device, mesh):
        return _evaluate(args, cfg, ckpt_dir, device, mesh)


def _evaluate(args, cfg, ckpt_dir: str, device, mesh):
    primary = is_primary()
    out_dir = args.out or os.path.join(ckpt_dir, "test")
    if primary:
        os.makedirs(out_dir, exist_ok=True)

    template = init_train_state(cfg.model, cfg.train, device=device)
    template.generator = None  # eval draws no noise: any device's checkpoint
    state = restore_checkpoint(ckpt_dir, template, step=args.step)
    if primary:
        print(f"restored step={state.step} from {ckpt_dir}")

    ds = get_dataset(cfg.data, "test", white_bkgd=cfg.model.white_bkgd)
    lpips_weights = None
    if args.lpips:
        lpips_weights = {k: torch.as_tensor(v, device=device)
                         for k, v in load_weights(args.lpips).items()}
    elif primary:
        print("LPIPS: no --lpips weights file; reporting PSNR/SSIM only")

    # The next view's rays go to the device while the current one renders.
    def _stage(i):
        rays_np, pix = ds.image(i)
        return rays_to_device(rays_np, device), pix

    stager = BackgroundStager(_stage, range(ds.n_images), depth=2)
    psnrs, ssims, lpipss = [], [], []
    try:  # finally-close so a render failure can't leak the staging thread
        for i in range(ds.n_images):
            rays, pix = stager.get()
            rgb, dist, acc = render_image(state.params, cfg.model, rays,
                                          chunk=args.chunk, mesh=mesh,
                                          device=device)
            rgb, dist, acc = (x.cpu().numpy() for x in (rgb, dist, acc))
            rgb = rgb.reshape(ds.h, ds.w, 3)
            dist = dist.reshape(ds.h, ds.w)
            acc = acc.reshape(ds.h, ds.w)

            if primary:
                save_png(os.path.join(out_dir, f"rgb_{i:04d}.png"), to8b(rgb))
                if args.depth:
                    save_png(os.path.join(out_dir, f"dist_{i:04d}.png"),
                             to8b(visualize_depth(dist, acc, ds.near, ds.far)))
                if args.normals:
                    save_png(os.path.join(out_dir, f"norm_{i:04d}.png"),
                             to8b(visualize_normals(dist, acc)))

            if pix is not None:
                target = pix.reshape(ds.h, ds.w, 3)
                psnr = metrics.psnr(rgb, target)
                s = (metrics.ssim(rgb, target)
                     if min(ds.h, ds.w) >= 11 else None)
                psnrs.append(psnr)
                ssims.append(s)
                line = f"[{i + 1}/{ds.n_images}] PSNR={psnr:.2f}"
                if s is not None:
                    line += f" SSIM={s:.4f}"
                if lpips_weights is not None:
                    lp = float(lpips(torch.as_tensor(rgb, device=device),
                                     target, lpips_weights))
                    lpipss.append(lp)
                    line += f" LPIPS={lp:.4f}"
                if primary:
                    print(line)
    finally:
        stager.close()

    if not psnrs:
        return None
    if primary:
        print(f"mean PSNR over {len(psnrs)} views: {np.mean(psnrs):.3f}")
    summary = {
        "step": int(state.step),
        "n_views": len(psnrs),
        "mean_psnr": float(np.mean(psnrs)),
        "per_view_psnr": [float(p) for p in psnrs],
    }
    if all(s is not None for s in ssims):
        summary["mean_ssim"] = float(np.mean(ssims))
        summary["per_view_ssim"] = [float(s) for s in ssims]
    if lpipss:
        summary["mean_lpips"] = float(np.mean(lpipss))
    if primary:
        if "mean_ssim" in summary:
            print(f"mean SSIM over {len(ssims)} views: "
                  f"{summary['mean_ssim']:.4f}")
        if lpipss:
            print(f"mean LPIPS over {len(lpipss)} views: "
                  f"{summary['mean_lpips']:.4f}")
        with open(os.path.join(out_dir, "eval.json"), "w") as f:
            json.dump(summary, f, indent=2)
        print(f"wrote {os.path.join(out_dir, 'eval.json')}")
    return summary


if __name__ == "__main__":
    main()
