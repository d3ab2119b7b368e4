"""The port's video entry point (``mipnerf360_torch/apps/video.py``) and its
MJPEG writer (``utils/video_io.py``) on the CPU: the AVI bytes against the
JAX package's, the app end to end on a port-trained and on a JAX-trained
checkpoint, its three writers, and ``chip_smoke.py``'s captures through
both packages' loaders and the port's train and video apps."""
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import chip_smoke
from mipnerf360_torch.apps import train as train_app
from mipnerf360_torch.apps import video as video_app
from mipnerf360_torch.config import DataConfig
from mipnerf360_torch.data import get_dataset
from mipnerf360_torch.utils.png import read_png
from mipnerf360_torch.utils.video_io import read_mjpeg_avi, write_mjpeg_avi
from mipnerf360_tpu.config import DataConfig as JaxDataConfig
from mipnerf360_tpu.data import get_dataset as jax_get_dataset
from mipnerf360_tpu.utils import video_io as jax_video_io

torch.set_num_threads(1)

SETS = ["model.num_samples=8", "model.hidden_proposal=16",
        "model.hidden_nerf=16", "model.nerf_depth=2",
        "model.compute_dtype=float32", "data.dataset=synthetic",
        "data.synthetic_resolution=8", "data.synthetic_views=3"]
TRAIN = ["train.max_steps=2", "train.batch_size=8", "train.log_every=2",
         "train.save_every=0", "train.eval_every=0"]


def _argv(sets):
    return [a for s in sets for a in ("--set", s)]


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("port_ckpt"))
    train_app.main(["--device", "cpu"] + _argv(
        SETS + TRAIN + [f"train.checkpoint_dir={ckpt}"]))
    return ckpt


def _frames(n=3, h=10, w=14):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def test_mjpeg_avi_is_byte_identical_to_jax(tmp_path):
    frames = _frames()
    ours, theirs = str(tmp_path / "a.avi"), str(tmp_path / "b.avi")
    assert write_mjpeg_avi(ours, frames, fps=24) == ours
    jax_video_io.write_mjpeg_avi(theirs, frames, fps=24)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    back = read_mjpeg_avi(ours)
    assert len(back) == 3
    for a, b in zip(back, jax_video_io.read_mjpeg_avi(theirs)):
        np.testing.assert_array_equal(a, b)


def _no_modules(monkeypatch, *names):
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)


def _working_imageio(monkeypatch, written):
    fake = types.ModuleType("imageio")

    def mimwrite(path, frames, fps, quality):
        written[path] = [np.array(f) for f in frames]
        open(path, "wb").write(b"mp4")

    fake.mimwrite = mimwrite
    monkeypatch.setitem(sys.modules, "imageio", fake)


def _broken_imageio(monkeypatch):
    fake = types.ModuleType("imageio")

    def mimwrite(*args, **kwargs):
        raise RuntimeError("no ffmpeg")

    fake.mimwrite = mimwrite
    monkeypatch.setitem(sys.modules, "imageio", fake)


@pytest.mark.parametrize("writer", ["mp4", "avi", "frames"])
def test_video_app_writers(port_ckpt, tmp_path, monkeypatch, writer):
    """mp4 through imageio; without it an MJPEG .avi; without PIL too, PNG
    frames through the port's own writer. Every writer gets the same
    frames."""
    out = str(tmp_path / "out")
    argv = ["--ckpt", port_ckpt, "--out", out, "--chunk", "64", "--depth",
            "--normals", "--device", "cpu"]
    # the reference frames: an imageio that keeps what it is given
    want = {}
    with monkeypatch.context() as m:
        _working_imageio(m, want)
        ref = video_app.main(argv + ["--out", str(tmp_path / "ref")])
    assert ref["n_frames"] == 3 and (ref["h"], ref["w"]) == (8, 8)
    assert ref["step"] == 2 and ref["rays_per_sec"] > 0
    names = ("video", "depth", "normals")
    for name in names:
        frames = want[str(tmp_path / "ref" / f"{name}.mp4")]
        assert len(frames) == 3 and frames[0].shape == (8, 8, 3)

    got = {}
    with monkeypatch.context() as m:
        if writer == "mp4":
            _working_imageio(m, got)
        else:
            _broken_imageio(m)
        if writer == "frames":
            _no_modules(m, "PIL", "PIL.Image")
        summary = video_app.main(argv)
    for name in names:
        path = summary["outputs"][name]
        expected = {"mp4": f"{name}.mp4", "avi": f"{name}.avi",
                    "frames": f"{name}.mp4.frames"}[writer]
        assert path == os.path.join(out, expected)
        ref_frames = want[str(tmp_path / "ref" / f"{name}.mp4")]
        if writer == "mp4":
            frames = got[path]
        elif writer == "avi":
            # the same bytes as the reference frames written at 30 fps
            again = write_mjpeg_avi(str(tmp_path / "again.avi"), ref_frames,
                                    fps=30)
            assert open(path, "rb").read() == open(again, "rb").read()
            frames = ref_frames
        else:
            assert sorted(os.listdir(path)) == ["0000.png", "0001.png",
                                                "0002.png"]
            frames = [read_png(os.path.join(path, f"{i:04d}.png"))
                      for i in range(3)]
        assert len(frames) == 3
        for a, b in zip(frames, ref_frames):
            np.testing.assert_array_equal(a, b)


def test_video_of_a_jax_run_matches_a_jax_render(tmp_path, monkeypatch):
    """The port's video of a JAX-trained checkpoint (``.msgpack``) against
    the JAX package's render of the same poses: within one 8-bit level."""
    import jax

    from mipnerf360_tpu.apps import train as jax_train_app
    from mipnerf360_tpu.config import Config
    from mipnerf360_tpu.core.rays import rays_to_device
    from mipnerf360_tpu.data.viz import to8b
    from mipnerf360_tpu.models.mipnerf360 import render_image
    from mipnerf360_tpu.train.checkpoint import restore_checkpoint
    from mipnerf360_tpu.train.state import abstract_train_state

    ckpt = str(tmp_path / "jax_ckpt")
    old = sys.argv
    try:
        sys.argv = ["prog"] + _argv(SETS + TRAIN + [
            "model.white_bkgd=true", "train.lr_delay_steps=0",
            f"train.checkpoint_dir={ckpt}"])
        jax_train_app.main()
    finally:
        sys.argv = old
    out = str(tmp_path / "video")
    with monkeypatch.context() as m:
        _broken_imageio(m)
        _no_modules(m, "PIL", "PIL.Image")
        summary = video_app.main(["--ckpt", ckpt, "--out", out, "--chunk",
                                  "64", "--device", "cpu"])
    assert summary["step"] == 2 and summary["n_frames"] == 3

    with open(os.path.join(ckpt, "config.json")) as f:
        cfg = Config.from_json(f.read())
    state = restore_checkpoint(ckpt, abstract_train_state(
        jax.random.PRNGKey(cfg.train.seed), cfg.model, cfg.train))
    ds = jax_get_dataset(cfg.data, "render", white_bkgd=cfg.model.white_bkgd)
    for i in range(ds.n_images):
        rgb, _, _ = render_image(state.params, cfg.model,
                                 rays_to_device(ds.image(i)[0]), chunk=64)
        want = to8b(np.asarray(rgb).reshape(ds.h, ds.w, 3))
        got = read_png(os.path.join(out, "video.mp4.frames", f"{i:04d}.png"))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_llff_capture_of_chip_smoke_loads_alike_and_trains(tmp_path):
    """``chip_smoke.write_llff_capture`` at a small size: both packages'
    loaders give the same arrays (nerf_360, metric rays), the held-out
    centre rays meet at the sphere inside [near, far], and the port's train
    and video apps run on it as ``garden_quality`` does, on the CPU."""
    capture = tmp_path / "garden"
    chip_smoke.write_llff_capture(capture, 17, 24, 16, 8)
    kw = dict(dataset="nerf_360", base_dir=str(capture), factor=8,
              use_ndc=False, n_render_poses=3)
    for split in ("train", "test", "render"):
        got = get_dataset(DataConfig(**kw), split, white_bkgd=False)
        want = jax_get_dataset(JaxDataConfig(**kw), split, white_bkgd=False)
        for g, w in zip(got.rays, want.rays):
            np.testing.assert_array_equal(g, w)
        if split != "render":
            np.testing.assert_array_equal(got.pixels, want.pixels)
    test = get_dataset(DataConfig(**kw), "test")
    assert (test.n_images, test.h, test.w) == (3, 16, 24)
    per = test.h * test.w
    ctr = (test.h // 2) * test.w + test.w // 2
    o, d = test.rays.origins[ctr::per], test.rays.viewdirs[ctr::per]
    a = sum(np.eye(3) - np.outer(di, di) for di in d)
    b = sum((np.eye(3) - np.outer(di, di)) @ oi for oi, di in zip(o, d))
    p = np.linalg.solve(a, b)
    depth = np.einsum("ij,ij->i", p - o, d)
    assert np.all(depth > test.near) and np.all(depth < test.far)
    # the sphere is lit where the centre rays meet it
    assert test.pixels[ctr::per].max() > 0.1

    ckpt = str(tmp_path / "ckpt")
    sets = ["model.num_samples=8", "model.hidden_proposal=16",
            "model.hidden_nerf=16", "model.nerf_depth=2",
            "train.batch_size=16", f"data.base_dir={capture}",
            f"train.checkpoint_dir={ckpt}", "train.max_steps=2",
            "train.log_every=1", "train.eval_image_every=2"]
    train_app.main(["--preset", "garden_quality", "--device", "cpu"]
                   + _argv(sets))
    with open(os.path.join(ckpt, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert recs[0]["data/device_bank"] == 1.0      # a small bank
    assert np.isfinite([r["train/loss"] for r in recs
                        if "train/loss" in r]).all()
    video = video_app.main(["--ckpt", ckpt, "--chunk", "128", "--device",
                            "cpu", "--set", "data.n_render_poses=2"])
    assert (video["n_frames"], video["h"], video["w"]) == (2, 16, 24)


def test_blender_capture_of_chip_smoke_loads_alike(tmp_path):
    capture = tmp_path / "lego"
    chip_smoke.write_blender_capture(capture, 5, 2, 16)
    assert sorted(os.listdir(capture / "test")) == ["r_0.png", "r_1.png"]
    for split in ("train", "test"):
        for white in (True, False):
            kw = dict(dataset="blender", base_dir=str(capture), factor=2)
            got = get_dataset(DataConfig(**kw), split, white_bkgd=white)
            want = jax_get_dataset(JaxDataConfig(**kw), split,
                                   white_bkgd=white)
            assert (got.n_images, got.h, got.w) == (
                {"train": 5, "test": 2}[split], 8, 8)
            np.testing.assert_array_equal(got.pixels, want.pixels)
            for g, w in zip(got.rays, want.rays):
                np.testing.assert_array_equal(g, w)
    rgba = read_png(str(capture / "train" / "r_0.png"))
    assert rgba.shape == (16, 16, 4)
    assert set(np.unique(rgba[..., 3])) == {0, 255}
    assert (rgba[..., :3][rgba[..., 3] == 0] == 0).all()
