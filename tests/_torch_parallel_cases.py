"""Inputs and configurations shared by the port's parallel tests and their
workers (not a pytest module; imports no JAX)."""
import numpy as np

from mipnerf360_torch.config import (Config, DataConfig, MeshConfig,
                                     ModelConfig, TrainConfig)
from mipnerf360_torch.core.rays import dummy_rays


def sample_axis_batch():
    """The batch of the JAX package's tests/test_parallel.py: rgb [16, 64,
    3], density [16, 64], t [16, 65], dirs [16, 3]."""
    rng = np.random.default_rng(0)
    b, n = 16, 64
    t = np.sort(rng.uniform(0.1, 6.0, (b, n + 1)), axis=-1).astype(np.float32)
    density = rng.gamma(1.0, 2.0, (b, n)).astype(np.float32)
    rgb = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    return rgb, density, t, dirs


# --- the data-parallel and tensor-parallel steps -----------------------------

DP_B, DP_N = 16, 8
DP_MODEL = dict(num_samples=DP_N, hidden_proposal=16, hidden_nerf=16,
                nerf_depth=2, compute_dtype="float32")
# (name, TrainConfig overrides) of the data-parallel cases, in the worker's
# order; "banded" patches the weight-bounds threshold below one rank's
# einsum transient.
DP_CASES = [
    ("joint", {}),
    ("joint_sum", dict(dist_loss_reduction="sum", dist_loss_weight=0.01)),
    ("collapsed", dict(quirk_collapsed_bounds=True)),
    ("reference", dict(cadence="reference")),
    ("banded", {}),
]


def dp_config(model=None, **train) -> Config:
    t = dict(batch_size=DP_B, max_steps=100, lr_delay_steps=0, **train)
    return Config(model=ModelConfig(**dict(DP_MODEL, **(model or {}))),
                  train=TrainConfig(**t))


def dp_batch(b: int = DP_B):
    rays = dummy_rays(b, seed=7)
    pixels = np.random.default_rng(7).uniform(size=(b, 3)).astype(np.float32)
    return rays, pixels


def banded_threshold(ranks: int) -> int:
    """One byte below a rank's [B/P, N, N] float32 einsum transient."""
    return (DP_B // ranks) * DP_N * DP_N * 4 - 1


# Tensor parallelism: an odd trunk depth on (1, 2) ends on split columns
# (the gather path), an even one on (2, 2) on a row split.
TP_MESHES = {2: (1, 2, 3), 4: (2, 2, 2)}   # ranks: (data, model, depth)


def tp_config(depth: int) -> Config:
    return dp_config(model=dict(nerf_depth=depth, hidden_nerf=32))


# --- the trainer ----------------------------------------------------------------

def trainer_config(ckpt_dir: str, data: int, max_steps: int = 6) -> Config:
    """A tiny synthetic run: device bank, background staging, a batch eval
    and an image eval (collective on a mesh), keep_best, saves."""
    return Config(
        model=ModelConfig(num_samples=8, hidden_proposal=16, hidden_nerf=16,
                          nerf_depth=2, compute_dtype="float32",
                          white_bkgd=True),
        train=TrainConfig(max_steps=max_steps, batch_size=16, log_every=3,
                          save_every=3, eval_every=3, eval_image_every=6,
                          eval_image_views=1, eval_image_chunk=24,
                          keep_best=True, lr_delay_steps=2,
                          lr_max_steps=12, stage_mode="device_bank",
                          async_staging=True, checkpoint_dir=ckpt_dir),
        data=DataConfig(dataset="synthetic", synthetic_resolution=8,
                        synthetic_views=2),
        mesh=MeshConfig(data=data, model=1))
