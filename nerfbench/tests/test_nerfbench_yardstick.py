"""The yardstick's counts against hand sums at small shapes."""
from __future__ import annotations

import numpy as np
import pytest

from nerfbench import yardstick as ys

SMALL = {"num_samples": 3, "hidden_proposal": 8, "proposal_depth": 2,
         "hidden_nerf": 16, "nerf_depth": 2, "ipe_min_deg": 0,
         "ipe_max_deg": 1, "viewdir_min_deg": 0, "viewdir_max_deg": 1}


def test_input_dim():
    assert ys.input_dim(SMALL) == 46
    quality = dict(SMALL, ipe_max_deg=5, viewdir_max_deg=4)
    assert ys.input_dim(quality) == 226


def test_mlp_flops_hand_sum():
    # prop 46-8-8-1, trunk 46-16-16, density 16-1, rgb 16-3
    fwd_macs = (46 * 8 + 8 * 8 + 8 * 1) + (46 * 16 + 16 * 16) + 16 + 48
    # dX for every layer but the first of prop and trunk; heads take dX
    dx_macs = (8 * 8 + 8 * 1) + (16 * 16) + 16 + 48
    fwd, bwd = ys.mlp_flops_per_sample(SMALL)
    assert fwd == 2 * fwd_macs
    assert bwd == 2 * fwd_macs + 2 * dx_macs
    assert ys.flops_per_ray(SMALL, train=False) == 3 * 2 * fwd_macs
    assert ys.flops_per_ray(SMALL, train=True) == 3 * (4 * fwd_macs + 2 * dx_macs)


def test_quality_flops_per_ray():
    quality = {"num_samples": 64, "hidden_proposal": 256, "proposal_depth": 4,
               "hidden_nerf": 1024, "nerf_depth": 8, "ipe_min_deg": 0,
               "ipe_max_deg": 5, "viewdir_min_deg": 0, "viewdir_max_deg": 4}
    prop = 226 * 256 + 3 * 256 * 256 + 256
    nerf = 226 * 1024 + 7 * 1024 * 1024 + 1024 + 3 * 1024
    assert ys.flops_per_ray(quality, False) == 64 * 2 * (prop + nerf)
    dx = (prop - 226 * 256) + (nerf - 226 * 1024)
    assert ys.flops_per_ray(quality, True) == 64 * 2 * (2 * (prop + nerf) + dx)


def test_composite_bounds_hand_sum():
    b, n = 4, 2
    k1_bytes = 4 * (b * n + b * (n + 1) + 3 * b) + 4 * b * n
    assert k1_bytes == 4 * (8 + 12 + 12) + 32
    assert ys.k1_bound_s(b, n) == pytest.approx(
        max(k1_bytes / ys.HBM_BYTES_PER_S, (8 * b * n + 5 * b) / ys.F32_FLOPS_PER_S))
    k2_bytes = k1_bytes + 4 * b * n
    assert ys.k2_bound_s(b, n) == pytest.approx(
        max(k2_bytes / ys.HBM_BYTES_PER_S, (16 * b * n + 5 * b) / ys.F32_FLOPS_PER_S))
    # at the train shape the bytes bound it
    assert ys.bound_s(4 * (4096 * 64 * 2 + 4096 * 65 + 3 * 4096),
                      8 * 4096 * 64)[1] == "bytes"


@pytest.mark.parametrize("name,cls", [
    ("void composite_fwd_regs<16, true>(float const*)", ys.K1),
    ("_Z17composite_bwd_regsILi16ELb1EEvPKf", ys.K2),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", ys.GEMM),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize", ys.GEMM),
    ("cutlass::Kernel2<cutlass_80_wmma_tensorop_s161616gemm>", ys.GEMM),
    ("void at::native::vectorized_elementwise_kernel<4>", ys.OTHER),
    ("Memcpy HtoD (Pageable -> Device)", ys.OTHER),
])
def test_kernel_class(name, cls):
    assert ys.kernel_class(name) == cls


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    assert ys.union_s(iv) == pytest.approx(2.0 + 1.0 + 1.0)
    assert ys.idle_gaps(iv, -1.0, 8.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 6.0),
                                          (7.0, 8.0)]
    assert ys.union_s([]) == 0.0
    assert ys.idle_gaps([], 0.0, 1.0) == [(0.0, 1.0)]


@pytest.mark.parametrize("n", [1, 2, 7, 20])
def test_percentile_matches_numpy(n):
    xs = np.random.default_rng(n).random(n).tolist()
    for q in (0, 50, 95, 100):
        assert ys.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_class_tables():
    table = [("composite_fwd_regs", 4, 1e-5), ("nvjet_x", 10, 3e-3),
             ("elementwise", 100, 2e-3), ("composite_bwd_regs", 2, 3e-5)]
    assert ys.class_seconds(table) == pytest.approx(
        {ys.K1: 1e-5, ys.K2: 3e-5, ys.GEMM: 3e-3, ys.OTHER: 2e-3})
    assert ys.class_launches(table) == {ys.K1: 4, ys.K2: 2, ys.GEMM: 10,
                                        ys.OTHER: 100}
