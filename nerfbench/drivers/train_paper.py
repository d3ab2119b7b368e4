"""Training traffic of the published network: ``drivers/train.py``'s chunk
loop, first steps, window and check, with that layout's weights and plain
reference.

``drivers/train.py`` reaches the weights and the reference through its
module names ``weights`` and ``ref``. This driver loads a copy of that
module of its own and points those two names at ``nerfbench/paper.py``'s
weights and ``reference/paper_model.py``; its segment names the composite
kernels' shapes of this layout; everything else is the train driver as it
is.
"""
from __future__ import annotations

import importlib.util
import types
from pathlib import Path

from nerfbench import paper, weights
from nerfbench.reference import paper_model


def _train_driver():
    path = Path(__file__).with_name("train.py")
    spec = importlib.util.spec_from_file_location(
        "nerfbench_driver_train_of_paper", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.ref = paper_model
    mod.weights = types.SimpleNamespace(
        make_params=paper.make_params, noise_generator=weights.noise_generator,
        leaves=weights.leaves)
    return mod


class Driver(_train_driver().Driver):
    def segment(self) -> dict:
        """The train driver's segment, with the [rays, samples] of each K1
        and K2 launch of a step (``paper.composite_shapes``): each proposal
        round's and the NeRF level's."""
        work = super().segment()
        shapes = paper.composite_shapes(self.cell.config["model"], self.batch)
        work["composite"] = {"K1": shapes, "K2": shapes}
        return work
