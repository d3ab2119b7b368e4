"""Dispatch of the model's composite and resample steps (counterpart of
``mipnerf360_tpu/ops/fused.py``).

``mode`` is ``ModelConfig.use_pallas``, kept for config compatibility. Here
the device decides: a CUDA tensor goes through the Hopper kernel, a CPU
tensor through the plain PyTorch version. ``"off"`` with a CUDA tensor
raises, since the card has no plain path.
"""
from __future__ import annotations

from ..core import sampling
from . import composite

_MODES = ("auto", "on", "off")


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"use_pallas must be one of {_MODES}, got {mode!r}")


def compute_alpha_weights(density, t_vals, dirs, mode: str = "auto"):
    """Density -> compositing weights (K1 on CUDA tensors, and K2 in the
    backward when the density requires grad)."""
    _check_mode(mode)
    if mode == "off" and density.is_cuda:
        raise ValueError(
            "use_pallas='off' with a CUDA tensor: on the card the composite "
            "runs only as the Hopper kernel; pass CPU tensors for the plain "
            "version")
    return composite.composite_weights(density, t_vals, dirs)


def resample_along_rays(t_vals, weights, randomized: bool,
                        resample_padding: float, mode: str = "auto",
                        u_typo: bool = False, *, noise=None, generator=None):
    """Blur + inverse-CDF resampling. Always the plain path: the JAX package
    has no resample kernel either (see its ops/fused.py)."""
    _check_mode(mode)
    return sampling.resample_along_rays(t_vals, weights, randomized,
                                        resample_padding, u_typo=u_typo,
                                        noise=noise, generator=generator)
