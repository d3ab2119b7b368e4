"""The plain reference against the program at a tiny size on the CPU.
The test imports the program; the reference does not."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from nerfbench import capture, harness, weights
from nerfbench.reference import model as ref
from nerfbench.reference import rays as ref_rays

CELLS = ["garden_quality.train", "blender_lego_quality.train",
         "garden_quality.render"]


def _setup(root, cell_name):
    cell = harness.find_cell(cell_name, root)
    cap_dir, _ = capture.ensure(cell.config["capture"], cell.folder / ".cache")
    return cell, cap_dir, harness.port_config(cell, cap_dir)


@pytest.mark.parametrize("cell_name", ["garden_quality.train",
                                       "blender_lego_quality.train"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_rays_and_pixels_match_the_loader(tiny_root, cell_name, split):
    from mipnerf360_torch.data import get_dataset

    cell, cap_dir, cfg = _setup(tiny_root, cell_name)
    ds = get_dataset(cfg.data, split, white_bkgd=cfg.model.white_bkgd)
    cap = ref_rays.Capture(cap_dir, cell.config["data"], split,
                           cell.config["model"]["white_bkgd"])
    assert (cap.n_rays, cap.h, cap.w) == (ds.n_rays, ds.h, ds.w)
    idx = np.arange(cap.n_rays)
    mine = cap.rays(idx)
    for field in mine:
        np.testing.assert_allclose(mine[field], getattr(ds.rays, field),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(cap.pixels(idx), ds.pixels)


def test_batch_indices_are_the_trainers(tiny_root):
    from mipnerf360_torch.data import get_dataset

    _, _, cfg = _setup(tiny_root, "garden_quality.train")
    ds = get_dataset(cfg.data, "train", white_bkgd=False)
    seed = 2**31 + 77
    stack = ds.index_stack(3, 64, seed, 0)
    for step in range(3):
        np.testing.assert_array_equal(
            ref_rays.batch_indices(seed, step, 64, ds.n_rays), stack[step])


@pytest.mark.parametrize("cell_name", ["garden_quality.train",
                                       "blender_lego_quality.train"])
@pytest.mark.parametrize("randomized", [True, False])
def test_forward_matches_the_program(tiny_root, cell_name, randomized):
    from mipnerf360_torch.core.rays import Rays
    from mipnerf360_torch.models.mipnerf360 import render_rays

    cell, cap_dir, cfg = _setup(tiny_root, cell_name)
    model = cell.config["model"]
    cap = ref_rays.Capture(cap_dir, cell.config["data"], "train",
                           model["white_bkgd"])
    rays = ref.to_device(cap.rays(np.arange(0, cap.n_rays, 3)), "cpu")
    params = weights.make_params(model, 11, "cpu")
    noise = (ref.draw_noise(torch.Generator().manual_seed(4),
                            rays["near"].shape[0], model["num_samples"])
             if randomized else None)
    with torch.no_grad():
        got = render_rays(params, cfg.model, Rays(**rays), randomized,
                          noise=noise)
        want = ref.forward(model, params, rays, noise)
    for a, b in (("t_prop", "t_prop"), ("w_prop", "w_prop"), ("t_vals", "t"),
                 ("weights", "w"), ("rgb", "rgb"), ("acc", "acc"),
                 ("distance", "distance")):
        torch.testing.assert_close(got[a], want[b], rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_run_is_correct_at_float32(tiny_root, cell_name):
    """The whole run on the CPU: the program in float32 agrees with the
    reference to round-off, far under every limit (a render's numbers are
    in units of the reference's own gap in bfloat16)."""
    out = harness.run_cell(cell_name, 2**31 + 5, 2.0, False, "cpu", 0.0,
                           tiny_root)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    for name, c in out["checks"].items():
        assert c["value"] < (1e-2 if cell_name.endswith("render") else 1e-4), (
            name, c)


def test_the_noise_is_the_programs(tiny_root):
    """The reference's draws are the ones a program step takes from the
    same generator, in the same order."""
    from mipnerf360_torch.models.mipnerf360 import draw_render_noise

    a = draw_render_noise(torch.Generator().manual_seed(9), 32, 8, "cpu")
    b = ref.draw_noise(torch.Generator().manual_seed(9), 32, 8)
    torch.testing.assert_close(a.sample, b[0], rtol=0, atol=0)
    torch.testing.assert_close(a.resample, b[1], rtol=0, atol=0)


def test_learning_rate_is_the_programs():
    from mipnerf360_torch.train.schedule import log_lerp_lr

    train = {"lr_init": 2e-3, "lr_final": 2e-5, "lr_max_steps": 10000,
             "lr_delay_steps": 2500, "lr_delay_mult": 0.01}
    for k in (0, 1, 2, 1000, 2500, 9999, 12000):
        want = float(log_lerp_lr(k, 2e-3, 2e-5, 10000, 2500, 0.01))
        assert ref.learning_rate(train, k) == pytest.approx(want, rel=1e-6)
