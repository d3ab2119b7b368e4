#!/usr/bin/env bash
# Dataset-free demo of the PyTorch/CUDA port: the full train -> eval -> video
# pipeline on the built-in procedural scene (no data on disk required), with
# the synthetic_quality preset (config.py QUALITY_MODEL/QUALITY_TRAIN).
#
# The JAX package's demo/demo_synthetic.sh with `python -m
# mipnerf360_torch.apps.*` and the same presets, flags and defaults. Its only
# two differences:
# - DEVICE (default cuda) is passed as --device; DEVICE=cpu runs on the CPU.
# - the script's own arguments ("$@") go to the end of each of the three
#   commands. Later --set overrides win, so `demo_synthetic.sh --set
#   train.max_steps=3000` changes the schedule and `--set model.hidden_nerf=32`
#   shrinks the model (eval and video read the model from the checkpoint's
#   config.json, so a --set given to train carries over).
#
# The JAX package's record of this demo (31.1 dB mean / 0.983 SSIM over 7
# held-out views after 1500 steps) is a TPU v5e's; the port's run on an
# NVIDIA H100 is in PRESET_VALIDATION_TORCH.json. STEPS=10000 (the preset
# default) is the PARITY_PSNR.json "convergence" regime.
set -euo pipefail

CKPT=${CKPT:-log/synthetic_quality}
STEPS=${STEPS:-1500}
DEVICE=${DEVICE:-cuda}

python -m mipnerf360_torch.apps.train --preset synthetic_quality \
    --set train.max_steps="$STEPS" --set train.checkpoint_dir="$CKPT" \
    --set train.log_every=100 --set train.eval_image_every=500 \
    --device "$DEVICE" "$@"

# holdout-view eval at the best-eval checkpoint: PSNR/SSIM + rgb/depth/normals
python -m mipnerf360_torch.apps.eval --ckpt "$CKPT" --step best \
    --chunk 4096 --depth --normals --device "$DEVICE" "$@"

# spherical-path video (playable MJPEG .avi when no ffmpeg is available)
python -m mipnerf360_torch.apps.video --ckpt "$CKPT" --step best --chunk 4096 \
    --device "$DEVICE" "$@"
