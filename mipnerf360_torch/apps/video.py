"""Path-render video CLI (counterpart of ``mipnerf360_tpu/apps/video.py``).

Renders the dataset's render split (a spiral path for forward-facing
scenes, a spherical orbit for 360 scenes) and writes ``video.mp4`` (30 fps),
plus ``depth.mp4`` and ``normals.mp4`` with ``--depth`` and ``--normals``.
Each video goes to the first writer that works: an mp4 through imageio, an
MJPEG ``.avi`` beside it (``utils/video_io.py``, PIL's JPEG encoder), or the
frames as ``<name>.mp4.frames/NNNN.png`` (the port's own PNG writer, which
needs no imaging library). Reads the port's checkpoints and the JAX
package's. Under torchrun with more than one rank every rank renders its
share of each frame and rank 0 writes the videos.

    python -m mipnerf360_torch.apps.video --ckpt ckpt/ [--device cpu]
    torchrun --nproc_per_node=N -m mipnerf360_torch.apps.video --ckpt ckpt/
"""
from __future__ import annotations

import argparse
import os
import time

from ..core.rays import rays_to_device
from ..data import get_dataset
from ..data.viz import to8b, visualize_depth, visualize_normals
from ..models.mipnerf360 import render_image
from ..parallel.mesh import is_primary
from ..train.checkpoint import restore_checkpoint
from ..train.state import init_train_state
from ..train.trainer import BackgroundStager
from ..utils.png import save_png
from .common import add_config_args, config_from_args, render_setup


def _write_video(path: str, frames, fps: int = 30) -> str:
    """Write uint8 [H, W, 3] ``frames`` through the first writer that works
    and return where they went: ``path`` (mp4), its ``.avi``, or its
    ``.frames`` directory of PNGs."""
    try:
        import imageio

        imageio.mimwrite(path, frames, fps=fps, quality=10)
        print(f"wrote {path}")
        return path
    except Exception as e:  # no imageio, or no ffmpeg behind it
        mp4_err = e
    try:
        from ..utils.video_io import write_mjpeg_avi

        avi = os.path.splitext(path)[0] + ".avi"
        write_mjpeg_avi(avi, frames, fps=fps)
        print(f"mp4 writer unavailable ({mp4_err}); wrote MJPEG {avi}")
        return avi
    except Exception as e:  # no PIL for the JPEG encoder
        frame_dir = path + ".frames"
        os.makedirs(frame_dir, exist_ok=True)
        for i, f in enumerate(frames):
            save_png(os.path.join(frame_dir, f"{i:04d}.png"), f)
        print(f"video writers unavailable ({mp4_err}; {e}); "
              f"wrote frames to {frame_dir}")
        return frame_dir


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None), render the path and
    write the videos. Returns {"step", "n_frames", "h", "w", "rays_per_sec"
    (rays over the host time of the render loop), "outputs" {video name:
    where it went}, empty off rank 0}."""
    ap = argparse.ArgumentParser(description=__doc__)
    add_config_args(ap)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--step", default=None,
                    type=lambda s: int(s) if s.isdigit() else s,
                    help="checkpoint step to load (default: latest), or "
                         "'best' for the best-eval checkpoint")
    ap.add_argument("--out", default="")
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--depth", action="store_true")
    ap.add_argument("--normals", action="store_true")
    args = ap.parse_args(argv)

    # Resolve the checkpoint dir first, so that its saved config.json
    # supplies the model without re-typing --set.
    pre = config_from_args(args)
    ckpt_dir = args.ckpt or pre.train.checkpoint_dir
    cfg = config_from_args(args, ckpt_dir=ckpt_dir)
    with render_setup(args, cfg) as (device, mesh):
        return _render(args, cfg, ckpt_dir, device, mesh)


def _render(args, cfg, ckpt_dir: str, device, mesh):
    primary = is_primary()
    out_dir = args.out or ckpt_dir
    if primary:
        os.makedirs(out_dir, exist_ok=True)

    template = init_train_state(cfg.model, cfg.train, device=device)
    template.generator = None  # rendering draws no noise
    state = restore_checkpoint(ckpt_dir, template, step=args.step)
    if primary:
        print(f"restored step={state.step} from {ckpt_dir}")

    ds = get_dataset(cfg.data, "render", white_bkgd=cfg.model.white_bkgd)

    # The next pose's rays are generated and moved to the device while the
    # current one renders.
    def _stage(i):
        rays_np, _ = ds.image(i)
        return rays_to_device(rays_np, device)

    stager = BackgroundStager(_stage, range(ds.n_images), depth=2)
    rgb_frames, depth_frames, normal_frames = [], [], []
    t0 = time.perf_counter()
    try:  # finally-close so a render failure can't leak the staging thread
        for i in range(ds.n_images):
            rays = stager.get()
            rgb, dist, acc = render_image(state.params, cfg.model, rays,
                                          chunk=args.chunk, mesh=mesh,
                                          device=device)
            rgb, dist, acc = (x.cpu().numpy() for x in (rgb, dist, acc))
            rgb = rgb.reshape(ds.h, ds.w, 3)
            dist = dist.reshape(ds.h, ds.w)
            acc = acc.reshape(ds.h, ds.w)
            rgb_frames.append(to8b(rgb))
            if args.depth:
                depth_frames.append(
                    to8b(visualize_depth(dist, acc, ds.near, ds.far)))
            if args.normals:
                normal_frames.append(to8b(visualize_normals(dist, acc)))
            if primary:
                print(f"rendered pose {i + 1}/{ds.n_images}")
    finally:
        stager.close()
    render_s = time.perf_counter() - t0

    outputs = {}
    if primary:
        outputs["video"] = _write_video(os.path.join(out_dir, "video.mp4"),
                                        rgb_frames)
        if args.depth:
            outputs["depth"] = _write_video(
                os.path.join(out_dir, "depth.mp4"), depth_frames)
        if args.normals:
            outputs["normals"] = _write_video(
                os.path.join(out_dir, "normals.mp4"), normal_frames)
    return {"step": int(state.step), "n_frames": ds.n_images, "h": ds.h,
            "w": ds.w, "rays_per_sec": ds.n_rays / render_s,
            "outputs": outputs}


if __name__ == "__main__":
    main()
