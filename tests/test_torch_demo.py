"""The port's demo scripts (``mipnerf360_torch/demo/*.sh``) end to end on the
CPU: each runs under bash with ``DEVICE=cpu`` on a model and scene shrunk
through the script's own arguments (appended to each of its three
commands), and its train, eval ``--step best`` and video must all run.

Also: each script is the JAX package's ``demo/*.sh`` with the port's
``python -m`` commands and only its two additions (``DEVICE`` and
``"$@"``), and without a card and without ``DEVICE=cpu`` it fails rather
than run on the CPU.
"""
import json
import os
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from mipnerf360_torch.apps.video import written_frames
from mipnerf360_torch.config import Config
from mipnerf360_torch.data import get_dataset
from mipnerf360_torch.tools.parity_psnr import export_llff_scene
from mipnerf360_torch.tools.preset_record import python_shim_dir

REPO = Path(__file__).resolve().parents[1]
DEMO = REPO / "mipnerf360_torch" / "demo"
# Each script's limit: its three commands at the sizes below take ~25 s.
TIMEOUT_S = 300
STEPS = 2
SMALL = ["model.num_samples=8", "model.hidden_proposal=16",
         "model.hidden_nerf=32", "model.nerf_depth=2",
         "train.batch_size=64", f"train.eval_image_every={STEPS}"]
SYNTHETIC = ["data.synthetic_resolution=16", "data.synthetic_views=4"]
RENDER_POSES = 4


def _sets(sets):
    return [a for s in sets for a in ("--set", s)]


def _env(tmp_path: Path, **extra) -> dict:
    """The environment of a script: a ``python`` on the PATH that runs this
    interpreter, the repo on PYTHONPATH."""
    bin_dir = python_shim_dir(tmp_path)
    path = [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]
    return dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
                PYTHONPATH=os.pathsep.join(path), OMP_NUM_THREADS="2",
                **extra)


def _run(script: str, args, env) -> subprocess.CompletedProcess:
    return subprocess.run(["bash", str(DEMO / script), *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)


def _check_outputs(ckpt: Path, frames_expected: int):
    """The checkpoint, its best manifest, a finite eval of every held-out
    view at the best checkpoint, and the video's frames."""
    assert (ckpt / f"ckpt_{STEPS}.pt").is_file()
    assert (ckpt / "ckpt_best.pt").is_file()
    manifest = json.loads((ckpt / "manifest.json").read_text())
    assert np.isfinite(manifest["best_psnr_image"])
    cfg = Config.from_json((ckpt / "config.json").read_text())
    test = get_dataset(cfg.data, "test", white_bkgd=cfg.model.white_bkgd)
    summary = json.loads((ckpt / "test" / "eval.json").read_text())
    assert summary["step"] == STEPS
    assert summary["n_views"] == test.n_images > 0
    for key in ("per_view_psnr", "per_view_ssim"):
        values = summary[key]
        assert len(values) == test.n_images and np.isfinite(values).all()
    for i in range(test.n_images):
        for kind in ("rgb", "dist", "norm"):
            assert (ckpt / "test" / f"{kind}_{i:04d}.png").is_file()
    assert written_frames(str(ckpt / "video.mp4")) == frames_expected


def test_demo_synthetic_runs_on_the_cpu(tmp_path):
    ckpt = tmp_path / "ckpt"
    env = _env(tmp_path, DEVICE="cpu", STEPS=str(STEPS), CKPT=str(ckpt))
    res = _run("demo_synthetic.sh", _sets(SMALL + SYNTHETIC), env)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    # the synthetic render split orbits through synthetic_views poses
    _check_outputs(ckpt, frames_expected=4)
    cfg = json.loads((ckpt / "config.json").read_text())
    assert cfg["preset"] == "synthetic_quality"
    assert cfg["train"]["max_steps"] == STEPS
    assert cfg["model"]["hidden_nerf"] == 32


def test_demo_360_runs_on_the_cpu(tmp_path):
    # 32 views, as the preset record's scene: on an orbit of 8 the mean
    # viewing direction is 0, and the recentring of both packages' LLFF
    # loaders divides by its norm (NaN rays).
    scene = tmp_path / "scene"
    export_llff_scene(str(scene), res=16, n_views=32)
    ckpt = tmp_path / "ckpt"
    env = _env(tmp_path, DEVICE="cpu", DATA=str(scene), CKPT=str(ckpt))
    res = _run("demo_360.sh", _sets(SMALL + [
        "data.factor=1", f"train.max_steps={STEPS}",
        f"data.n_render_poses={RENDER_POSES}"]), env)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    _check_outputs(ckpt, frames_expected=RENDER_POSES)
    cfg = json.loads((ckpt / "config.json").read_text())
    assert cfg["preset"] == "garden_quality"
    assert cfg["data"]["base_dir"] == str(scene)
    # video --depth: a depth video beside the rgb one
    assert written_frames(str(ckpt / "depth.mp4")) == RENDER_POSES


def test_demo_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    env = _env(tmp_path, STEPS=str(STEPS), CKPT=str(tmp_path / "ckpt"))
    env.pop("DEVICE", None)
    res = _run("demo_synthetic.sh", _sets(SMALL + SYNTHETIC), env)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stdout + res.stderr
    assert not (tmp_path / "ckpt" / f"ckpt_{STEPS}.pt").exists()


def _commands(text: str) -> list:
    """The script's statements (continuations joined, comments dropped,
    whitespace collapsed)."""
    lines = [ln for ln in text.replace("\\\n", " ").splitlines()
             if ln.strip() and not ln.lstrip().startswith("#")]
    return [" ".join(ln.split()) for ln in lines]


@pytest.mark.parametrize("script", ["demo_synthetic.sh", "demo_360.sh"])
def test_demo_is_the_jax_script_with_two_additions(script):
    """The port's script, with its ``DEVICE`` default and each command's
    ``--device "$DEVICE" "$@"`` taken out, is the JAX package's with
    ``mipnerf360_tpu`` replaced by ``mipnerf360_torch``."""
    port = _commands((DEMO / script).read_text())
    jax = _commands((REPO / "demo" / script).read_text())
    assert 'DEVICE=${DEVICE:-cuda}' in port
    stripped = [c.replace(' --device "$DEVICE" "$@"', "") for c in port
                if c != 'DEVICE=${DEVICE:-cuda}']
    assert stripped == [c.replace("mipnerf360_tpu", "mipnerf360_torch")
                        for c in jax]
    pythons = [c for c in port if c.startswith("python ")]
    assert len(pythons) == 3
    assert all(c.endswith(' --device "$DEVICE" "$@"') for c in pythons)
    assert re.search(r"^set -euo pipefail$", (DEMO / script).read_text(),
                     re.M)
