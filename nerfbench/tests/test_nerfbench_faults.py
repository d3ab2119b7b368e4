"""The rest of a run, past the look for a card, with the timed path broken
underneath: ``correct`` has to come out false for each fault a cell can
have on one card. (No cell spans cards, so none can lose an exchange
between them.) The control of each cell, the reference one precision
below the configuration's in the program's place, fails too."""
from __future__ import annotations

import pytest
import torch

from nerfbench import harness

CELLS = ["garden_quality.train", "blender_lego_quality.train",
         "garden_quality.render"]


def _run(root, cell):
    return harness.run_cell(cell, 2**31 + 9, 2.0, False, "cpu", 0.0, root)


def _drivers(monkeypatch, **readings_kw):
    """Make every run's driver record its last readings (returned dict),
    and take ``readings_kw`` in each call to ``readings``."""
    seen = {}
    whole = harness.driver_class

    def recording(cell):
        class Recording(whole(cell)):
            def readings(self, **kw):
                out = super().readings(**dict(kw, **readings_kw))
                seen.clear()
                seen.update(out)
                return out
        return Recording

    monkeypatch.setattr(harness, "driver_class", recording)
    return seen


def test_sound_runs_pass(tiny_root):
    for cell in ("garden_quality.train", "garden_quality.render"):
        assert _run(tiny_root, cell)["correct"]


def test_step_that_returns_its_state_unchanged(tiny_root, monkeypatch):
    from mipnerf360_torch.train import step

    monkeypatch.setattr(step, "apply_updates_subtree", lambda *a, **k: None)
    out = _run(tiny_root, "garden_quality.train")
    assert not out["correct"]
    assert out["checks"]["delta_gap"]["value"] > out["checks"]["delta_gap"]["limit"]


def test_half_the_batch_left_out(tiny_root, monkeypatch):
    """Each step sees the first half of its rays; the loss is the mean over
    those."""
    from mipnerf360_torch.core.rays import rays_map
    from mipnerf360_torch.train import step

    whole = step.joint_cadence_step

    def half(cfg, state, rays, pixels, **kw):
        h = pixels.shape[0] // 2
        return whole(cfg, state, rays_map(lambda x: x[:h], rays), pixels[:h],
                     **kw)

    monkeypatch.setattr(step, "joint_cadence_step", half)
    out = _run(tiny_root, "blender_lego_quality.train")
    assert not out["correct"]


def test_distillation_gradient_scaled(tiny_root, monkeypatch):
    """The distillation loss counts twice: only the proposal MLP's
    gradient changes, the NeRF level's losses do not, and AdamW's first
    steps hardly see a scale. ``grad_gap_prop`` catches it."""
    from mipnerf360_torch.train import step

    whole = step.distillation_loss
    monkeypatch.setattr(step, "distillation_loss",
                        lambda *a, **k: 2.0 * whole(*a, **k))
    out = _run(tiny_root, "garden_quality.train")
    assert not out["correct"]
    got = out["checks"]["grad_gap_prop"]
    assert got["value"] > got["limit"]


def test_answer_altered_where_it_is_produced(tiny_root, monkeypatch):
    """Every ray's red channel moves, in the render forward, by twice the
    rgb limit in its own unit: the widest rgb gap of the reference computed
    in the configuration's bfloat16, read from a sound run of the same
    seed."""
    from mipnerf360_torch.models import mipnerf360

    name = "garden_quality.render"
    seen = _drivers(monkeypatch)
    assert _run(tiny_root, name)["correct"]
    unit = seen["rgb_widest"] / seen["rgb_gap"]
    limit = harness.find_cell(name, tiny_root).limits["rgb_gap"]["limit"]
    whole = mipnerf360.render_rays

    def altered(*a, **k):
        out = whole(*a, **k)
        out["rgb"] = out["rgb"] + torch.tensor([2 * limit * unit, 0.0, 0.0])
        return out

    monkeypatch.setattr(mipnerf360, "render_rays", altered)
    out = _run(tiny_root, name)
    assert not out["correct"]
    assert out["checks"]["rgb_gap"]["value"] > limit


@pytest.mark.parametrize("name", CELLS)
def test_controls_fail(tiny_root_bf16, monkeypatch, name):
    """With the tiny cells' products in the configurations' bfloat16, a
    run is correct; with the float8 control in the program's place, the
    same run, through the harness, is not."""
    assert _run(tiny_root_bf16, name)["correct"]
    _drivers(monkeypatch, matmul="float8")
    out = _run(tiny_root_bf16, name)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
