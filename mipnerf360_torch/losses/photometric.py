"""Photometric reconstruction loss and PSNR (counterpart of
``mipnerf360_tpu/losses/photometric.py``).

The trained quantity is ``30 - PSNR``, a log-MSE reparameterization of the
reference's loss.
"""
from __future__ import annotations

import torch

from ..parallel.collectives import global_sum, group_size


def mse_to_psnr(mse):
    return -10.0 * torch.log10(mse)


def psnr_to_mse(psnr):
    return torch.pow(10.0, -psnr / 10.0)


def photometric_loss(pred_rgb, target_rgb, group=None):
    """Returns (train_loss = 30 - PSNR, psnr).

    MSE is summed over channels and averaged over rays, so the returned
    ``psnr`` reads 10*log10(3) ~= 4.77 dB below the standard image PSNR, as
    in the JAX package; do not compare it against image PSNRs.

    ``group``: the rays are this rank's rows of a batch split over the
    group, and both values are the global batch's (the squared error summed
    over the group; the loss is not linear in it, so averaging per-rank
    losses would be another function).
    """
    batch = pred_rgb.shape[0] * group_size(group)
    sse = torch.sum((pred_rgb[..., :3] - target_rgb[..., :3]) ** 2)
    mse = global_sum(sse, group) / batch
    psnr = mse_to_psnr(mse)
    return 30.0 - psnr, psnr

