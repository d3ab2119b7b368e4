"""The port's entry points (``mipnerf360_torch/apps``) on the CPU: train then
eval through the real ``main``s, the eval of a JAX-trained directory against
the JAX package's ``eval.json``, the PNG writer the apps use, and the NumPy
helpers the eval copies from the JAX package (metrics, viz)."""
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from mipnerf360_torch.apps import eval as eval_app
from mipnerf360_torch.apps import train as train_app
from mipnerf360_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from mipnerf360_torch.core.rays import dummy_rays
from mipnerf360_torch.data import get_dataset, viz
from mipnerf360_torch.models.mipnerf360 import init_model, render_image
from mipnerf360_torch.train.trainer import train
from mipnerf360_torch.utils import metrics
from mipnerf360_torch.utils.png import save_png
from mipnerf360_tpu.apps import eval as jax_eval_app
from mipnerf360_tpu.apps import train as jax_train_app
from mipnerf360_tpu.data import viz as jviz
from mipnerf360_tpu.utils import metrics as jmetrics

torch.set_num_threads(1)

# tests/test_apps.py's sizes
SETS = [
    "model.num_samples=8", "model.hidden_proposal=16", "model.hidden_nerf=16",
    "model.nerf_depth=2", "model.compute_dtype=float32",
    "data.dataset=synthetic", "data.synthetic_resolution=8",
    "data.synthetic_views=2",
]
TRAIN = ["train.max_steps=4", "train.batch_size=8", "train.log_every=2",
         "train.save_every=0", "train.eval_every=0"]


def _argv(sets):
    return [a for s in sets for a in ("--set", s)]


def test_train_then_eval(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    state = train_app.main(["--device", "cpu"] + _argv(
        SETS + TRAIN + ["train.eval_image_every=2",
                        f"train.checkpoint_dir={ckpt}"]))
    assert state.step == 4
    assert {"config.json", "ckpt_4.pt", "ckpt_best.pt", "manifest.json",
            "metrics.jsonl"} <= set(os.listdir(ckpt))
    assert "[step=4] loss=" in capsys.readouterr().out

    # config.json supplies the model: no --set needed
    out = str(tmp_path / "eval")
    summary = eval_app.main(["--ckpt", ckpt, "--out", out, "--chunk", "64",
                             "--depth", "--normals", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "restored step=4" in printed and "mean PSNR over 2 views" in printed
    with open(os.path.join(out, "eval.json")) as f:
        assert json.load(f) == summary
    assert summary["step"] == 4 and summary["n_views"] == 2
    assert np.isfinite(summary["per_view_psnr"]).all()
    assert "mean_ssim" not in summary            # 8x8 views: no SSIM window
    for kind in ("rgb", "dist", "norm"):
        for i in range(2):
            img = np.asarray(Image.open(os.path.join(out, f"{kind}_{i:04d}.png")))
            assert img.shape == (8, 8, 3) and img.dtype == np.uint8

    best = eval_app.main(["--ckpt", ckpt, "--out", out, "--step", "best",
                          "--chunk", "64", "--device", "cpu"])
    with open(os.path.join(ckpt, "manifest.json")) as f:
        assert best["step"] == json.load(f)["best_step"]


def test_eval_of_a_jax_run_matches_jax_eval(tmp_path, capsys):
    ckpt = str(tmp_path / "jax_ckpt")
    old = sys.argv
    try:
        sys.argv = ["prog"] + _argv(SETS + TRAIN + [
            "model.white_bkgd=true", "train.lr_delay_steps=0",
            f"train.checkpoint_dir={ckpt}"])
        jax_train_app.main()
        sys.argv = ["prog", "--ckpt", ckpt, "--out", str(tmp_path / "jax"),
                    "--chunk", "64"]
        jax_eval_app.main()
    finally:
        sys.argv = old
    got = eval_app.main(["--ckpt", ckpt, "--out", str(tmp_path / "port"),
                         "--chunk", "64", "--device", "cpu"])
    with open(tmp_path / "jax" / "eval.json") as f:
        want = json.load(f)
    assert got["step"] == want["step"] == 4
    assert got["n_views"] == want["n_views"] == 2
    np.testing.assert_allclose(got["per_view_psnr"], want["per_view_psnr"],
                               rtol=0, atol=1e-3)
    for i in range(2):
        a = np.asarray(Image.open(tmp_path / "port" / f"rgb_{i:04d}.png"))
        b = np.asarray(Image.open(tmp_path / "jax" / f"rgb_{i:04d}.png"))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_unported_paths_raise(tmp_path, monkeypatch):
    """Every dataset is ported (the Blender loader reads its directory, so a
    missing one raises FileNotFoundError) and ``--lpips`` takes a weights
    file. The parallel paths need a process group: ``--multihost`` outside
    torchrun, and the sample-axis render in one process, raise instead of
    running on one rank."""
    with pytest.raises(FileNotFoundError, match="transforms_train.json"):
        get_dataset(DataConfig(dataset="blender", base_dir=str(tmp_path)),
                    "train")
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset(DataConfig(dataset="nope"), "train")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no process group to join"):
        train_app.main(["--multihost", "--device", "cpu"])
    cfg = ModelConfig(num_samples=4, hidden_proposal=8, hidden_nerf=8,
                      nerf_depth=1, compute_dtype="float32", sample_shards=2)
    with pytest.raises(RuntimeError, match="needs a process group"):
        render_image(init_model(cfg), cfg, dummy_rays(2), device="cpu")


def test_entry_points_need_the_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = Config(train=TrainConfig(checkpoint_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_app.main(_argv(SETS + [f"train.checkpoint_dir={tmp_path}"]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_app.main(["--ckpt", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("shape", [(5, 7, 3), (64, 33, 3), (1, 1, 3)])
def test_png_writer_round_trips_through_pil(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    save_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    rgba = np.concatenate([img, img[..., :1]], -1)   # the writer takes RGBA
    save_png(path, rgba)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), rgba)
    with pytest.raises(ValueError):
        save_png(path, np.zeros((2, 2, 2), np.uint8))
    with pytest.raises(ValueError):
        save_png(path, np.zeros((2, 2), np.uint8))


def test_metrics_and_viz_match_jax():
    rng = np.random.default_rng(1)
    a, b = rng.uniform(size=(2, 16, 12, 3))
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert metrics.ssim(a, b) == jmetrics.ssim(a, b)
    depth = rng.uniform(2, 6, (9, 10))
    acc = rng.uniform(size=(9, 10))
    depth[0, 0] = np.nan
    np.testing.assert_array_equal(viz.visualize_depth(depth, acc, 2.0, 6.0),
                                  jviz.visualize_depth(depth, acc, 2.0, 6.0))
    np.testing.assert_array_equal(viz.visualize_normals(depth, acc),
                                  jviz.visualize_normals(depth, acc))
    np.testing.assert_array_equal(viz.to8b(a), jviz.to8b(a))
