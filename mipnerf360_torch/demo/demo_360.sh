#!/usr/bin/env bash
# Canonical CLI recipes of the PyTorch/CUDA port (counterpart of reference
# demo/demo_360.sh:1-8): train the nerf_360 garden scene, render the holdout
# views, make a video.
#
# Uses the garden_quality preset, the paper-faithful model proven to
# converge (PARITY_PSNR.json "convergence"). The plain `garden` preset
# reproduces the reference's quirks, including the non-convergence its own
# README admits (reference README.md:9); use it only for parity studies.
#
# The JAX package's demo/demo_360.sh with `python -m mipnerf360_torch.apps.*`
# and the same presets, flags and defaults. Its only two differences:
# - DEVICE (default cuda) is passed as --device; DEVICE=cpu runs on the CPU.
# - the script's own arguments ("$@") go to the end of each of the three
#   commands. Later --set overrides win, so `demo_360.sh --set
#   data.factor=1 --set train.max_steps=2000` trains a capture without
#   downscaled images for 2,000 steps.
set -euo pipefail

DATA=${DATA:-data/nerf_360/garden}
CKPT=${CKPT:-log/garden}
DEVICE=${DEVICE:-cuda}

# train 10k steps (the reference demo's operating point)
python -m mipnerf360_torch.apps.train --preset garden_quality \
    --set data.base_dir="$DATA" --set train.max_steps=10000 \
    --set train.checkpoint_dir="$CKPT" --device "$DEVICE" "$@"

# holdout-view eval at the best-eval checkpoint: PSNR + rgb/depth/normals
python -m mipnerf360_torch.apps.eval --ckpt "$CKPT" --step best --depth \
    --normals --device "$DEVICE" "$@"

# 360-degree spherical-path video
python -m mipnerf360_torch.apps.video --ckpt "$CKPT" --step best --depth \
    --device "$DEVICE" "$@"
