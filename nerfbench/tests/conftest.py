"""Tiny copies of the benchmark for the CPU tests: a root with its own
``BENCHMARK.json`` and a copy of the ``nerfbench`` folder, whose cells run
the real configurations' model and step at a few rays and a few units of
width, in float32 (``tiny_root``) or in the configurations' bfloat16
(``tiny_root_bf16``)."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_MODEL = {"num_samples": 8, "hidden_proposal": 16, "proposal_depth": 2,
              "hidden_nerf": 32, "nerf_depth": 3, "compute_dtype": "float32"}
TINY_TRAIN = {"batch_size": 64, "log_every": 4, "eval_image_chunk": 256}
TINY_CAPTURES = {
    "garden_quality": {"name": "tiny_llff", "layout": "llff", "views": 17,
                       "width": 24, "height": 16, "factor": 8},
    "blender_lego_quality": {"name": "tiny_blender", "layout": "blender",
                             "train": 6, "test": 3, "res": 16},
}


def pytest_configure(config):
    import torch

    torch.set_num_threads(2)    # the tests run beside each other
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


def make_tiny_root(tmp: Path, compute_dtype: str = "float32") -> Path:
    """A root whose BENCHMARK.json has the repo's cells at the tiny sizes,
    their matrix products in ``compute_dtype``."""
    model = dict(TINY_MODEL, compute_dtype=compute_dtype)
    root = tmp / "root"
    shutil.copytree(REPO / "nerfbench", root / "nerfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in TINY_CAPTURES:
        path = root / "nerfbench" / "configs" / f"{name}.json"
        conf = json.loads(path.read_text())
        conf["model"].update(model)
        conf["train"].update(TINY_TRAIN)
        conf["set"].update({f"model.{k}": v for k, v in model.items()})
        conf["set"].update({f"train.{k}": v for k, v in TINY_TRAIN.items()})
        conf["capture"] = copy.deepcopy(TINY_CAPTURES[name])
        path.write_text(json.dumps(conf))
    for mix, changes in (("train_preset", {"warmup_steps": 8}),
                         ("render_views", {"check_rays": 128})):
        path = root / "nerfbench" / "traffic" / f"{mix}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()), **changes)))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("nerfbench"))


@pytest.fixture(scope="session")
def tiny_root_bf16(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("nerfbench_bf16"),
                          "bfloat16")
