"""Photometric reconstruction loss and PSNR (counterpart of
``mipnerf360_tpu/losses/photometric.py``).

The trained quantity is ``30 - PSNR``, a log-MSE reparameterization of the
reference's loss.
"""
from __future__ import annotations

import torch


def mse_to_psnr(mse):
    return -10.0 * torch.log10(mse)


def psnr_to_mse(psnr):
    return torch.pow(10.0, -psnr / 10.0)


def photometric_loss(pred_rgb, target_rgb):
    """Returns (train_loss = 30 - PSNR, psnr).

    MSE is summed over channels and averaged over rays, so the returned
    ``psnr`` reads 10*log10(3) ~= 4.77 dB below the standard image PSNR, as
    in the JAX package; do not compare it against image PSNRs.
    """
    batch = pred_rgb.shape[0]
    mse = torch.sum((pred_rgb[..., :3] - target_rgb[..., :3]) ** 2) / batch
    psnr = mse_to_psnr(mse)
    return 30.0 - psnr, psnr

