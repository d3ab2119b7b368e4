"""Learning-rate schedule: log-linear lerp with a sine warmup delay
(counterpart of ``mipnerf360_tpu/train/schedule.py``), as a pure function of
the step, computed in float32 as the JAX package computes it."""
from __future__ import annotations

import math

import torch


def log_lerp_lr(step, lr_init: float, lr_final: float, max_steps: int,
                lr_delay_steps: int = 0, lr_delay_mult: float = 1.0):
    """LR at ``step``, a 0-d float32 tensor on the CPU."""
    f32 = torch.float32
    step = torch.as_tensor(step, dtype=f32)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1.0 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(
        torch.log(torch.tensor(lr_init, dtype=f32)) * (1.0 - t)
        + torch.log(torch.tensor(lr_final, dtype=f32)) * t)
    return delay_rate * log_lerp
