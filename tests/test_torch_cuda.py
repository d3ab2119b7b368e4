"""The port on the card: kernels K1 and K2 against their plain versions, the
render path's launches and results against the CPU, and a small train step
on the card against the CPU. Every test here needs an NVIDIA card and the
CUDA toolkit, and skips without them.

This file imports no JAX, so it runs on a machine with a card and without
JAX; tests/conftest.py imports JAX, hence ``--noconftest`` (see README).
"""
import dataclasses

import numpy as np
import pytest
import torch

from mipnerf360_torch.config import Config, ModelConfig, TrainConfig
from mipnerf360_torch.core.rays import dummy_rays, rays_to_device
from mipnerf360_torch.models import mipnerf360 as tm
from mipnerf360_torch.models.mlp import apply_mlp, init_mlp
from mipnerf360_torch.ops import composite
from mipnerf360_torch.train import init_train_state, joint_cadence_grads
from mipnerf360_torch.train.state import make_train_state

pytestmark = pytest.mark.cuda

# Kernel vs plain version: the JAX package's Pallas-vs-core tolerances,
# forward and backward (tests/test_pallas_ops.py).
K1_TOL = dict(rtol=1e-5, atol=1e-6)
K2_TOL = dict(rtol=1e-4, atol=1e-5)
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


def _at_offset(x, device, offset=1):
    """``x`` on ``device`` as a contiguous view ``offset`` floats into a
    larger buffer, so its storage is not 16-byte aligned."""
    buf = torch.full((x.numel() + offset,), float("nan"), device=device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.storage_offset() == offset
    return view


# The train batch (and render chunk), ragged B with small N, one ray with N
# not a multiple of 4, near-zero density (the expm1 region), opaque rays (T
# underflows), one ray past a whole number of 16-ray tiles, rows that are
# not 16-byte multiples (N = 1, 3), the longest ray one register chunk
# holds (N = 128), and rays of 2 and 40 chunks of 128 samples (N = 256,
# 5000), where K2 parks T in its output row.
SHAPES = [(4096, 64, (0.0, 3.0)), (300, 16, (0.0, 3.0)), (1, 65, (0.0, 3.0)),
          (1024, 64, (0.0, 1e-4)), (1024, 64, (50.0, 500.0)),
          (4097, 64, (0.0, 3.0)), (300, 1, (0.0, 3.0)), (300, 3, (0.0, 3.0)),
          (1024, 128, (0.0, 3.0)), (512, 256, (0.0, 3.0)),
          (3, 5000, (0.0, 1.0))]


@pytest.mark.parametrize("b,n,density_range", SHAPES)
def test_k1_matches_plain_version(cuda, b, n, density_range):
    args = [x.to(cuda) for x in _inputs(b, n, 7, density_range)]
    before = composite.launches
    w = composite.composite_weights(*args)
    assert composite.launches == before + 1
    torch.testing.assert_close(w, composite.plain_composite_weights(*args), **K1_TOL)


@pytest.mark.parametrize("b,n,density_range", SHAPES)
def test_k2_matches_plain_version(cuda, b, n, density_range):
    args = [x.to(cuda) for x in _inputs(b, n, 8, density_range)]
    g = torch.from_numpy(np.random.default_rng(9).normal(
        size=(b, n)).astype(np.float32)).to(cuda)
    before = composite.bwd_launches
    got = composite._launch_bwd(*args, g)
    assert composite.bwd_launches == before + 1
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got, composite.plain_composite_weights_bwd(*args, g), **K2_TOL)


@pytest.mark.parametrize("b,n", [(4096, 64), (300, 3), (5, 1), (2, 5000)])
def test_kernels_at_a_storage_offset(cuda, b, n):
    """Inputs and cotangent that are contiguous views 4 bytes into a larger
    buffer: no row is 16-byte aligned, so the kernels take no 16-byte
    access, also where K2 reads back the T it parked (N = 5000)."""
    density, t_vals, dirs = _inputs(b, n, 10, (0.0, 3.0 if n < 1000 else 1.0))
    g = torch.from_numpy(np.random.default_rng(11).normal(
        size=(b, n)).astype(np.float32))
    aligned = [x.to(cuda) for x in (density, t_vals, dirs, g)]
    shifted = [_at_offset(x, cuda) for x in aligned]
    w = composite.composite_weights(*shifted[:3])
    got = composite._launch_bwd(*shifted)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        w, composite.plain_composite_weights(*aligned[:3]), **K1_TOL)
    torch.testing.assert_close(
        got, composite.plain_composite_weights_bwd(*aligned), **K2_TOL)


def test_k1_refuses_what_it_cannot_take(cuda):
    density, t_vals, dirs = [x.to(cuda) for x in _inputs(8, 16)]
    # a density that requires grad goes through K1, then K2 in the backward
    d = density.clone().requires_grad_()
    k1, k2 = composite.launches, composite.bwd_launches
    w = composite.composite_weights(d, t_vals, dirs)
    g = torch.randn(1, 16, device=cuda).expand(8, 16)  # expanded cotangent
    (got,) = torch.autograd.grad(w, [d], g)
    assert (composite.launches - k1, composite.bwd_launches - k2) == (1, 1)
    torch.testing.assert_close(
        got, composite.plain_composite_weights_bwd(density, t_vals, dirs,
                                                   g.contiguous()), **K2_TOL)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mlp_gradients_on_card_match_cpu(cuda, dtype):
    """The card's GEMM backward (bf16: the ``torch.mm(out_dtype=)`` Function)
    against the CPU's autograd. float32: rtol 1e-4 / atol 1e-4 on every
    entry. bfloat16: dX and dW are rounded to bf16 and another summation
    order flips some roundings, so each leaf is held by its relative L2
    error, at 2e-2."""
    params = init_mlp(torch.Generator().manual_seed(1), [58, 256, 256, 4])
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(512, 58)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(512, 4)).astype(np.float32))
    acts = ["relu", "relu", "none"]
    grads = {}
    for dev in ("cpu", cuda):
        p = tm.map_params(lambda t: t.to(dev).requires_grad_(), params)
        xd = x.to(dev).requires_grad_()
        out = apply_mlp(p, xd, acts, getattr(torch, dtype))
        leaves = [xd] + [l[k] for l in p["layers"] for k in ("w", "b")]
        grads[str(dev)] = torch.autograd.grad((out * r.to(dev)).sum(), leaves)
    for a, b in zip(grads["cuda"], grads["cpu"]):
        if dtype == "float32":
            torch.testing.assert_close(a.cpu(), b, **F32_TOL)
        else:
            assert ((a.cpu() - b).norm() / b.norm()).item() < 2e-2


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


def test_train_step_on_card_matches_cpu(cuda):
    """One joint step's gradients and losses, float32 with TF32 off: only
    summation orders differ (rtol 1e-4 / atol 1e-4, as for the render); both
    composites launch K1 and K2 once each."""
    cfg = Config(model=SMALL, train=TrainConfig(batch_size=64))
    cpu = init_train_state(cfg.model, cfg.train, device="cpu")
    card = make_train_state(cpu.params, device=cuda,
                            generator=torch.Generator(cuda))
    rays = dummy_rays(64, seed=3)
    pixels = torch.from_numpy(np.random.default_rng(3).uniform(
        size=(64, 3)).astype(np.float32))
    noise = tm.RenderNoise(*(torch.from_numpy(np.random.default_rng(s).uniform(
        size=(64, 17)).astype(np.float32)) * m for s, m in ((4, 1.0), (5, 1 / 18))))
    out = {}
    for dev, state in (("cpu", cpu), ("cuda", card)):
        k1, k2 = composite.launches, composite.bwd_launches
        out[dev] = joint_cadence_grads(
            cfg, state, rays_to_device(rays, dev), pixels.to(dev),
            noise=tm.RenderNoise(*(n.to(dev) for n in noise)))
        launched = (composite.launches - k1, composite.bwd_launches - k2)
        assert launched == ((0, 0) if dev == "cpu" else (2, 2))
    (g_cpu, aux_cpu), (g_card, aux_card) = out["cpu"], out["cuda"]
    for k in aux_cpu:
        torch.testing.assert_close(aux_card[k].cpu(), aux_cpu[k], **F32_TOL)
    for k in ("prop", "nerf"):
        for a, b in zip(g_card[k], g_cpu[k]):
            torch.testing.assert_close(a.cpu(), b, **F32_TOL)


def test_lpips_on_card_matches_cpu(cuda):
    """LPIPS of random weights: cuDNN convolutions in float32 with TF32 off
    against the CPU's, at rtol 1e-4."""
    from mipnerf360_torch.utils.lpips import lpips, random_weights

    weights = random_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    img, ref = rng.uniform(size=(2, 45, 61, 3)).astype(np.float32)
    want = float(lpips(img, ref, weights))
    got = lpips(torch.as_tensor(img, device=cuda), ref,
                {k: v.to(cuda) for k, v in weights.items()})
    assert got.is_cuda
    np.testing.assert_allclose(float(got), want, rtol=1e-4)


def test_checkify_fn_on_card(cuda):
    from mipnerf360_torch.utils.checks import NonFiniteError, checkify_fn

    x = torch.tensor([1.0, 4.0], device=cuda)
    with pytest.raises(NonFiniteError, match=r"nan generated by aten\.log"):
        checkify_fn(lambda t: torch.log(t - 2.0))(x)
    with pytest.raises(NonFiniteError, match="division by zero"):
        checkify_fn(lambda t: t / (t - 1.0))(x)
    torch.testing.assert_close(checkify_fn(torch.sqrt)(x), torch.sqrt(x))


def test_video_app_on_card(cuda, tmp_path):
    """apps.video end to end on the card: K1 twice per pose's chunk, frames
    within one 8-bit level of the CPU's."""
    from mipnerf360_torch.apps import train as train_app
    from mipnerf360_torch.apps import video as video_app
    from mipnerf360_torch.utils.png import read_png

    ckpt = str(tmp_path / "ckpt")
    sets = ["model.num_samples=16", "model.hidden_proposal=32",
            "model.hidden_nerf=64", "model.nerf_depth=3",
            "model.compute_dtype=float32", "data.synthetic_resolution=16",
            "data.synthetic_views=3", "train.max_steps=2",
            "train.batch_size=64", f"train.checkpoint_dir={ckpt}"]
    train_app.main([a for s in sets for a in ("--set", s)])
    frames = {}
    for dev in ("cpu", "cuda"):
        out = str(tmp_path / dev)
        before = composite.launches
        summary = video_app.main(["--ckpt", ckpt, "--out", out, "--chunk",
                                  "128", "--device", dev])
        assert composite.launches - before == (0 if dev == "cpu" else 3 * 2 * 2)
        path = summary["outputs"]["video"]
        assert summary["n_frames"] == 3
        frames[dev] = path
    if frames["cuda"].endswith(".frames"):
        for i in range(3):
            a = read_png(f"{frames['cuda']}/{i:04d}.png").astype(int)
            b = read_png(f"{frames['cpu']}/{i:04d}.png").astype(int)
            assert np.abs(a - b).max() <= 1


def test_bench_on_card(cuda):
    """tools.bench on the card: the line names the card (nvidia-smi's name
    and power limit), the compute-only loop launches K1 and K2 twice per
    step, and ``--pallas off`` raises (the card has no plain composite)."""
    from mipnerf360_torch.tools import bench

    base = Config(model=SMALL)
    flags = ["--batch", "64", "--steps", "2", "--warmup", "2", "--repeats",
             "1", "--quality"]
    k1, k2 = composite.launches, composite.bwd_launches
    out = bench.run(bench.parse_args(flags), base)
    assert (composite.launches - k1, composite.bwd_launches - k2) == (12, 12)
    assert out["card"] not in ("", "cpu") and "W" in out["card"]
    assert np.isfinite(out["value"]) and out["value"] > 0
    with pytest.raises(ValueError, match="use_pallas='off'"):
        bench.run(bench.parse_args(flags + ["--pallas", "off"]), base)


def test_parity_psnr_reference_cadence_on_card(cuda):
    """tools.parity_psnr on the card: quality-equal-batch's reference
    cadence launches K1 6 times and K2 3 times per step (two K1 per update,
    one K2 through the one level each update trains), two K1 per batch eval
    and per render chunk of each of the 4 held-out views; its section names
    the card."""
    from mipnerf360_torch.tools import parity_psnr as pp

    small = {k: getattr(SMALL, k) for k in (
        "num_samples", "hidden_proposal", "hidden_nerf", "nerf_depth",
        "compute_dtype")}
    args = pp.parse_args(["--mode", "quality-equal-batch", "--steps", "10",
                          "--res", "8"])
    k1, k2 = composite.launches, composite.bwd_launches
    section = pp.run(args, small)
    assert (composite.launches - k1, composite.bwd_launches - k2) == (
        6 * 10 + 2 + 2 * 4, 3 * 10)
    assert section["card"] not in ("", "cpu") and "W" in section["card"]
    assert section["wall_s"] > 0
