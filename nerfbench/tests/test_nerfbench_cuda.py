"""The tiny cells on the card: the whole run, traced, through the program's
CUDA kernels. Skips without a card. On the card:
``python3 -m pytest nerfbench/tests/test_nerfbench_cuda.py -q``."""
from __future__ import annotations

import pytest
import torch

from nerfbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["garden_quality.train",
                                  "blender_lego_quality.train",
                                  "garden_quality.render"])
def test_tiny_cell_on_the_card(tiny_root, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = harness.run_cell(cell, 2**31 + 21, 1.0, True, "cuda:0", 0.0,
                           tiny_root)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["metrics"] and out["breakdown"]["device_ops"]
