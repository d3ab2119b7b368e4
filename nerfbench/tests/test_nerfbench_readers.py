"""Each per-layer metric's reader on a canned traced-run summary."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

from nerfbench import yardstick as ys

METRICS = Path(__file__).resolve().parents[1] / "metrics"
MODEL = {"num_samples": 64, "hidden_proposal": 256, "proposal_depth": 4,
         "hidden_nerf": 1024, "nerf_depth": 8, "ipe_min_deg": 0,
         "ipe_max_deg": 5, "viewdir_min_deg": 0, "viewdir_max_deg": 4}
KERNELS = [("void composite_fwd_regs<16, true>", 40, 40 * 2.5e-6),
           ("void composite_bwd_regs<16, true>", 40, 40 * 5e-6),
           ("nvjet_tst_128x256_h_bz", 2000, 0.6),
           ("void at::native::elementwise_kernel", 30000, 0.9)]


def _read(metric, summary):
    spec = importlib.util.spec_from_file_location(
        "m_" + metric.replace(".", "_"), METRICS / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(summary)


def _train():
    return {"kind": "train", "model": MODEL,
            "window": {"rate": 47000.0, "chunk_s": [1.7, 1.8, 1.75, 1.72],
                       "rays": 4 * 20 * 4096, "seconds": 6.97},
            "segment": {"steps": 20, "rays": 20 * 4096,
                        "composite": {"K1": [4096, 64], "K2": [4096, 64]}},
            "kernels": KERNELS, "busy_s": 1.5, "wall_s": 1.75}


def _render():
    return {"kind": "render", "model": MODEL,
            "window": {"rate": 120000.0, "view_s": [2.3, 2.2, 2.4]},
            "segment": {"views": 1, "rays": 272160,
                        "composite": {"K1": [8192, 64]}},
            "kernels": KERNELS[:1] + KERNELS[2:], "busy_s": 2.0,
            "wall_s": 2.3}


def test_train_readers():
    s = _train()
    assert _read("chunk_ms_p95.train", s) == pytest.approx(
        ys.percentile([1.7, 1.8, 1.75, 1.72], 95) * 1e3)
    flops = ys.flops_per_ray(MODEL, True)
    assert _read("mfu.train", s) == pytest.approx(100 * flops * 47000 / 989e12)
    assert _read("gemm_roofline.train", s) == pytest.approx(
        100 * flops * 20 * 4096 / 989e12 / 0.6)
    assert _read("other_ms_per_step.train", s) == pytest.approx(900 / 20)
    need = 40 * ys.k1_bound_s(4096, 64) + 40 * ys.k2_bound_s(4096, 64)
    assert _read("composite_roofline.train", s) == pytest.approx(
        100 * need / (40 * 7.5e-6))
    assert _read("idle_share.train", s) == pytest.approx(100 * (1 - 1.5 / 1.75))


def test_render_readers():
    s = _render()
    assert _read("view_ms_p95.render", s) == pytest.approx(
        ys.percentile([2.3, 2.2, 2.4], 95) * 1e3)
    flops = ys.flops_per_ray(MODEL, False)
    assert _read("mfu.render", s) == pytest.approx(100 * flops * 120000 / 989e12)
    assert _read("gemm_roofline.render", s) == pytest.approx(
        100 * flops * 272160 / 989e12 / 0.6)
    assert _read("composite_roofline.render", s) == pytest.approx(
        100 * 40 * ys.k1_bound_s(8192, 64) / (40 * 2.5e-6))
    assert _read("idle_share.render", s) == pytest.approx(100 * (1 - 2.0 / 2.3))


@pytest.mark.parametrize("metric", sorted(p.stem for p in METRICS.glob("*.py")))
def test_reader_is_silent_where_it_has_nothing_to_read(metric):
    """A reader of the other kind of cell, or with no kernels, returns
    None, never 0."""
    other = _render() if metric.endswith(".train") else _train()
    assert _read(metric, other) is None
    own = _train() if metric.endswith(".train") else _render()
    own.update(kernels=[], busy_s=0.0)
    own["window"] = {"rate": own["window"]["rate"]}
    own["segment"] = {}
    if metric.startswith("mfu"):
        assert _read(metric, own) > 0
    else:
        assert _read(metric, own) is None
