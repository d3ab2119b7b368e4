"""LPIPS perceptual metric (VGG-16 backbone) in PyTorch (counterpart of
``mipnerf360_tpu/utils/lpips.py``, and held to it on the same weights).

LPIPS (Zhang et al., CVPR 2018) compares unit-normalized feature maps from
five VGG-16 taps (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3) through learned
per-channel linear calibration weights. It is defined by its pretrained
weights, which are not in the repo:

- ``lpips(img, ref, weights)``: the metric, given a weights dict in the JAX
  package's layout (``conv{i}_w`` HWIO [3, 3, in, out], ``conv{i}_b``,
  ``lin{l}``; NumPy arrays or tensors).
- ``load_weights(path)``: that dict from the ``.npz`` that the JAX package's
  ``tools/export_lpips_weights.py`` writes.
- ``random_weights(generator)``: He-initialized stand-in weights for tests.
  Their scores are not LPIPS and compare with no published number.

The convolutions are the JAX package's XLA convolutions, so here they are
``F.conv2d`` (cuDNN on the card) in float32 with TF32 off, NCHW/OIHW.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# VGG-16 "features" layout: conv widths per block, with the LPIPS taps after
# the last relu of each block (before its max-pool).
_VGG_BLOCKS = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512),
               (512, 512, 512))

# Input normalization on [-1, 1]-scaled rgb (Zhang et al.'s ScalingLayer).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def vgg16_features(x: torch.Tensor, weights: Dict[str, torch.Tensor]
                   ) -> List[torch.Tensor]:
    """Five tap activations of VGG-16 for [N, 3, H, W] input in [-1, 1]."""
    shift = x.new_tensor(_SHIFT).view(1, 3, 1, 1)
    scale = x.new_tensor(_SCALE).view(1, 3, 1, 1)
    x = (x - shift) / scale
    taps, i = [], 0
    for b, widths in enumerate(_VGG_BLOCKS):
        for _ in widths:
            # HWIO -> OIHW; 3x3 SAME padding at stride 1 is padding 1.
            kernel = weights[f"conv{i}_w"].permute(3, 2, 0, 1)
            x = F.relu(F.conv2d(x, kernel, weights[f"conv{i}_b"], padding=1))
            i += 1
        taps.append(x)
        if b < len(_VGG_BLOCKS) - 1:
            x = F.max_pool2d(x, 2, 2)             # 2x2 VALID: odd edges drop
    return taps


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f * torch.rsqrt(torch.sum(f * f, dim=1, keepdim=True) + eps)


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=device)


def lpips(img, ref, weights) -> torch.Tensor:
    """LPIPS distance between [H, W, 3] (or [N, H, W, 3]) images in [0, 1].

    d(x, y) = sum_l mean_hw || w_l * (f_l(x) - f_l(y)) ||^2 with f_l the
    unit-normalized tap activations and w_l = max(lin_l, 0). ``img``,
    ``ref`` and ``weights`` may be NumPy arrays or tensors; the metric runs
    on the device of ``img`` (the CPU when it is a NumPy array) and returns
    a 0-d float32 tensor there.
    """
    device = img.device if torch.is_tensor(img) else torch.device("cpu")
    x, y = _as_tensor(img, device), _as_tensor(ref, device)
    if x.ndim == 3:
        x, y = x[None], y[None]
    w = {k: _as_tensor(v, device) for k, v in weights.items()}
    x = (x * 2.0 - 1.0).permute(0, 3, 1, 2)
    y = (y * 2.0 - 1.0).permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), \
            torch.inference_mode():
        fx, fy = vgg16_features(x, w), vgg16_features(y, w)
        total = 0.0
        for l, (a, b) in enumerate(zip(fx, fy)):
            diff = _unit_normalize(a) - _unit_normalize(b)
            lin = torch.clamp_min(w[f"lin{l}"], 0.0).view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(lin * diff * diff, dim=1),
                                       dim=(-2, -1))
        return torch.mean(total)


def load_weights(path: str) -> Dict[str, np.ndarray]:
    """Load a weights dict from an ``.npz`` in the JAX package's layout."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def random_weights(generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
    """He-initialized VGG-16 and uniform lins, on the CPU: a test stand-in
    only (the scores it gives are not LPIPS)."""
    weights, in_c, i = {}, 3, 0
    for widths in _VGG_BLOCKS:
        for c in widths:
            fan_in = 3 * 3 * in_c
            weights[f"conv{i}_w"] = (torch.randn(3, 3, in_c, c,
                                                 generator=generator)
                                     * np.sqrt(2.0 / fan_in))
            weights[f"conv{i}_b"] = torch.zeros(c)
            in_c, i = c, i + 1
    for l, widths in enumerate(_VGG_BLOCKS):
        weights[f"lin{l}"] = torch.full((widths[-1],), 1.0 / widths[-1])
    return weights
