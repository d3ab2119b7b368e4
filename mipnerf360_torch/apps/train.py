"""Training CLI (counterpart of ``mipnerf360_tpu/apps/train.py``).

    python -m mipnerf360_torch.apps.train --preset synthetic_quality
    python -m mipnerf360_torch.apps.train --preset synthetic_quality --resume
    python -m mipnerf360_torch.apps.train ... --device cpu
    torchrun --nproc_per_node=N -m mipnerf360_torch.apps.train --multihost ...

``--multihost`` joins the process group torchrun describes (NCCL on the
card, gloo with ``--device cpu``) and trains on the ``mesh.*`` mesh over
it; a missing environment or a failed rendezvous raises.
"""
from __future__ import annotations

import argparse

from ..parallel.mesh import init_distributed, is_primary, shutdown
from ..train.trainer import train
from .common import add_config_args, config_from_args


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None), train, and return the
    final TrainState."""
    ap = argparse.ArgumentParser(description=__doc__)
    add_config_args(ap)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint (exact resume)")
    ap.add_argument("--multihost", action="store_true",
                    help="join the torchrun process group and train on "
                         "the mesh.* mesh over it")
    args = ap.parse_args(argv)

    cfg = config_from_args(args)
    if args.resume:
        # Re-resolve through the checkpoint dir's saved config.json so
        # `--resume` needs no model.* re-specification: the first pass only
        # locates checkpoint_dir (preset/--set); the second makes the saved
        # config the base, with the CLI overrides still applied on top.
        cfg = config_from_args(args, ckpt_dir=cfg.train.checkpoint_dir)

    def on_step(step, scalars):
        print(f"[step={step}] "
              f"loss={scalars['train/loss']:.4f} "
              f"psnr={scalars['train/avg_psnr']:.2f} "
              f"rays/s={scalars['perf/rays_per_sec']:.0f}", flush=True)

    if not args.multihost:
        return train(cfg, resume=args.resume, on_step=on_step,
                     device=args.device)
    device = init_distributed(args.device)
    try:
        return train(cfg, resume=args.resume, device=device,
                     on_step=on_step if is_primary() else None)
    finally:
        shutdown()


if __name__ == "__main__":
    main()
