"""The port on the card: kernel K1 against its plain version, and the render
path's launches and results against the CPU. Every test here needs an
NVIDIA card and the CUDA toolkit, and skips without them.

This file imports no JAX, so it runs on a machine with a card and without
JAX; tests/conftest.py imports JAX, hence ``--noconftest`` (see README).
"""
import dataclasses

import numpy as np
import pytest
import torch

from mipnerf360_torch.config import ModelConfig
from mipnerf360_torch.core.rays import dummy_rays, rays_to_device
from mipnerf360_torch.models import mipnerf360 as tm
from mipnerf360_torch.models.mlp import apply_mlp, init_mlp
from mipnerf360_torch.ops import composite

pytestmark = pytest.mark.cuda

# Kernel vs plain version: the JAX package's Pallas-vs-core tolerance.
K1_TOL = dict(rtol=1e-5, atol=1e-6)
# Whole path, float32 with TF32 off: only summation orders differ.
F32_TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = ModelConfig(num_samples=16, hidden_proposal=32, hidden_nerf=64,
                    nerf_depth=3, compute_dtype="float32", white_bkgd=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, n, seed=0, density_range=(0.0, 3.0)):
    rng = np.random.default_rng(seed)
    density = rng.uniform(*density_range, (b, n)).astype(np.float32)
    t_vals = np.sort(rng.uniform(0.1, 6.0, (b, n + 1)).astype(np.float32), -1)
    dirs = rng.normal(size=(b, 3)).astype(np.float32)
    return [torch.from_numpy(x) for x in (density, t_vals, dirs)]


@pytest.mark.parametrize("b,n,density_range", [
    (4096, 64, (0.0, 3.0)), (300, 16, (0.0, 3.0)), (1, 65, (0.0, 3.0)),
    (1024, 64, (0.0, 1e-4)), (1024, 64, (50.0, 500.0))])
def test_k1_matches_plain_version(cuda, b, n, density_range):
    args = [x.to(cuda) for x in _inputs(b, n, 7, density_range)]
    before = composite.launches
    w = composite.composite_weights(*args)
    assert composite.launches == before + 1
    torch.testing.assert_close(w, composite.plain_composite_weights(*args), **K1_TOL)


def test_k1_refuses_what_it_cannot_take(cuda):
    density, t_vals, dirs = [x.to(cuda) for x in _inputs(8, 16)]
    with pytest.raises(NotImplementedError, match="K2 not ported"):
        composite.composite_weights(density.clone().requires_grad_(), t_vals, dirs)
    with pytest.raises(TypeError):
        composite.composite_weights(density.double(), t_vals, dirs)
    with pytest.raises(ValueError):
        composite.composite_weights(density, t_vals[:, :-1].contiguous(), dirs)
    with pytest.raises(ValueError):
        composite.composite_weights(density.t().contiguous().t(), t_vals, dirs)
    with pytest.raises(ValueError):
        composite.composite_weights(density, t_vals, dirs.cpu())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mlp_on_card_matches_cpu(cuda, dtype):
    params = init_mlp(torch.Generator().manual_seed(0), [58, 256, 256, 4])
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(512, 58)).astype(np.float32))
    acts = ["relu", "relu", "none"]
    want = apply_mlp(params, x, acts, getattr(torch, dtype))
    card = tm.map_params(lambda p: p.to(cuda), params)
    got = apply_mlp(card, x.to(cuda), acts, getattr(torch, dtype))
    assert got.dtype == torch.float32
    # bf16: a different f32 summation order can flip the bf16 rounding of
    # a hidden unit by one ulp (2^-8 relative)
    tol = F32_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got.cpu(), want, **tol)


def test_render_image_launches_k1_twice_per_chunk_and_matches_cpu(cuda):
    params = tm.init_model(SMALL, torch.Generator().manual_seed(1))
    rays = dummy_rays(300, seed=1)
    before = composite.launches
    got = tm.render_image(params, SMALL, rays, chunk=128)
    assert composite.launches - before == 2 * 3
    assert all(x.is_cuda for x in got)
    want = tm.render_image(params, SMALL, rays, chunk=128, device="cpu")
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **F32_TOL)


def test_module_forward_on_card(cuda):
    cfg = dataclasses.replace(SMALL, compute_dtype="bfloat16")
    model = tm.MipNeRF360(cfg, generator=torch.Generator().manual_seed(2)).to(cuda)
    rays = rays_to_device(dummy_rays(64), cuda)
    with torch.inference_mode():
        out = model(rays)
    assert out["rgb"].shape == (64, 3) and torch.isfinite(out["rgb"]).all()
    rgb, _, _ = model.render_image(dummy_rays(64), chunk=64)
    torch.testing.assert_close(rgb, out["rgb"], rtol=1e-6, atol=1e-6)
