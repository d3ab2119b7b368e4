"""The port's data layer (``mipnerf360_torch/data``, ``core/ndc.py``) against
the JAX package's on fabricated Blender, LLFF and nerf_360 scenes: every
array bit for bit, for every split, both NDC settings and both backgrounds,
and the lazy render splits against their materialized rays."""
import dataclasses
import json
import os

import numpy as np
import pytest
from PIL import Image

from mipnerf360_torch.config import DataConfig
from mipnerf360_torch.core.ndc import convert_to_ndc
from mipnerf360_torch.data import LazyRenderDataset, RayDataset, get_dataset
from mipnerf360_torch.data import pose
from mipnerf360_torch.data.rays_gen import ndc_rays, pinhole_rays
from mipnerf360_tpu.config import DataConfig as JaxDataConfig
from mipnerf360_tpu.core.ndc import convert_to_ndc as jax_convert_to_ndc
from mipnerf360_tpu.data import get_dataset as jax_get_dataset
from mipnerf360_tpu.data import pose as jpose
from mipnerf360_tpu.data.rays_gen import ndc_rays as jax_ndc_rays


@pytest.fixture(scope="module")
def blender_dir(tmp_path_factory):
    """A Blender-layout scene (tests/test_data.py's fixture at 18x14, so
    that the half-res box filter drops nothing): RGBA PNGs with partial
    alpha and transforms_{train,test}.json."""
    root = tmp_path_factory.mktemp("blender")
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        os.makedirs(root / split)
        frames = []
        for i in range(3):
            img = rng.integers(0, 255, (14, 18, 4), dtype=np.uint8)
            Image.fromarray(img).save(root / split / f"r_{i}.png")
            c2w = np.eye(4)
            c2w[:3, 3] = [0.1 * i, 0, 4 + i]
            frames.append({"file_path": f"{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(root / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
    return str(root)


@pytest.fixture(scope="module")
def llff_dir(tmp_path_factory):
    """An LLFF-layout scene (tests/test_data.py's fixture): images_4/ and
    poses_bounds.npy with [down, right, back] rotation columns."""
    root = tmp_path_factory.mktemp("llff")
    rng = np.random.default_rng(1)
    os.makedirs(root / "images_4")
    n = 10
    rows = np.zeros((n, 17), np.float64)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (12, 16, 3), dtype=np.uint8)
                        ).save(root / "images_4" / f"img_{i:03d}.png")
        th = 0.1 * i
        c2w = jpose.look_at(np.array([np.sin(th) * 0.1, 0, 1.0]),
                            np.array([0, 1.0, 0]),
                            np.array([np.sin(th), 0.05 * i, 0.0]))
        m = np.concatenate([c2w, np.array([[48.0], [64.0], [50.0]])], 1)
        m = np.concatenate([-m[:, 1:2], m[:, 0:1], m[:, 2:]], 1)
        rows[i, :15] = m.reshape(-1)
        rows[i, 15:] = [1.0, 6.0]
    np.save(root / "poses_bounds.npy", rows)
    return str(root)


def _both(**kw):
    return DataConfig(**kw), JaxDataConfig(**kw)


def _assert_rays_equal(got, want):
    for name, g, w in zip(want._fields, got, want):
        assert g.dtype == np.float32 and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _assert_same_dataset(got, want):
    assert type(got).__name__ == type(want).__name__
    assert (got.h, got.w, got.n_images, got.n_rays) == (
        want.h, want.w, want.n_images, want.n_rays)
    assert (got.near, got.far) == (want.near, want.far)
    assert type(got.near) is type(want.near)
    if isinstance(got, LazyRenderDataset):
        np.testing.assert_array_equal(got.poses, want.poses)
        assert got.pixels is None and want.pixels is None
    else:
        np.testing.assert_array_equal(got.pixels, want.pixels)
    _assert_rays_equal(got.rays, want.rays)


SPLITS = ["train", "test", "visualize", "render"]


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("white_bkgd", [True, False])
def test_blender_matches_jax(blender_dir, split, white_bkgd):
    cfg, jcfg = _both(dataset="blender", base_dir=blender_dir, factor=2,
                      n_render_poses=3, render_h=6, render_w=5,
                      render_focal=7.0)
    got = get_dataset(cfg, split, white_bkgd=white_bkgd)
    want = jax_get_dataset(jcfg, split, white_bkgd=white_bkgd)
    _assert_same_dataset(got, want)
    if split != "render":
        assert (got.h, got.w) == (7, 9)            # half of 14x18


@pytest.mark.parametrize("spherify", [False, True])
def test_blender_render_paths_match_jax(blender_dir, spherify):
    cfg, jcfg = _both(dataset="blender", base_dir=blender_dir,
                      n_render_poses=4, render_spherify=spherify,
                      render_h=5, render_w=6, render_radius=3.5)
    _assert_same_dataset(get_dataset(cfg, "render"),
                         jax_get_dataset(jcfg, "render"))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("use_ndc", [True, False])
@pytest.mark.parametrize("dataset", ["llff", "nerf_360"])
def test_llff_and_nerf_360_match_jax(llff_dir, dataset, split, use_ndc):
    kw = dict(near=0.0, far=1.0) if use_ndc else {}
    cfg, jcfg = _both(dataset=dataset, base_dir=llff_dir, factor=4,
                      use_ndc=use_ndc, n_render_poses=5, **kw)
    got, want = get_dataset(cfg, split), jax_get_dataset(jcfg, split)
    _assert_same_dataset(got, want)
    n = {"train": 8, "test": 2, "visualize": 2, "render": 5}[split]
    assert got.n_images == n


@pytest.mark.parametrize("white_bkgd", [None, False])
def test_synthetic_render_split_matches_jax(white_bkgd):
    cfg, jcfg = _both(dataset="synthetic", synthetic_resolution=8,
                      synthetic_views=3, render_radius=4.0)
    got = get_dataset(cfg, "render", white_bkgd=white_bkgd)
    _assert_same_dataset(got, jax_get_dataset(jcfg, "render",
                                              white_bkgd=white_bkgd))
    origins = got.rays.origins.reshape(3, -1, 3)[:, 0]
    np.testing.assert_allclose(np.linalg.norm(origins, axis=-1), 4.0,
                               rtol=1e-5)


def _lazy_splits(blender_dir, llff_dir):
    return {
        "synthetic": DataConfig(dataset="synthetic", synthetic_resolution=8,
                                synthetic_views=3),
        "blender": DataConfig(dataset="blender", base_dir=blender_dir,
                              n_render_poses=3, render_h=6, render_w=5),
        "llff_ndc": DataConfig(dataset="llff", base_dir=llff_dir, factor=4,
                               near=0.0, far=1.0, n_render_poses=3),
        "nerf_360_metric": DataConfig(dataset="nerf_360", base_dir=llff_dir,
                                      factor=4, use_ndc=False,
                                      n_render_poses=3),
    }


@pytest.mark.parametrize("name", ["synthetic", "blender", "llff_ndc",
                                  "nerf_360_metric"])
def test_lazy_image_equals_materialized_slice(blender_dir, llff_dir, name):
    ds = get_dataset(_lazy_splits(blender_dir, llff_dir)[name], "render")
    assert isinstance(ds, LazyRenderDataset)
    full = ds.rays
    per = ds.h * ds.w
    assert full.origins.shape == (ds.n_rays, 3)
    images = list(ds.images())
    assert len(images) == ds.n_images
    for i, (rays_i, pix) in enumerate(images):
        assert pix is None
        for a, b in zip(rays_i, full):
            np.testing.assert_array_equal(a, b[i * per:(i + 1) * per])


def test_ray_dataset_images_yields_every_view(llff_dir):
    ds = get_dataset(DataConfig(dataset="llff", base_dir=llff_dir, factor=4,
                                near=0.0, far=1.0), "test")
    assert isinstance(ds, RayDataset)
    views = list(ds.images())
    assert len(views) == ds.n_images == 2
    for i, (rays, pix) in enumerate(views):
        np.testing.assert_array_equal(rays.origins, ds.image(i)[0].origins)
        np.testing.assert_array_equal(pix, ds.pixels[i * 192:(i + 1) * 192])


def test_convert_to_ndc_matches_jax():
    rng = np.random.default_rng(2)
    o = rng.normal(size=(4, 5, 6, 3)).astype(np.float32)
    d = rng.normal(size=(4, 5, 6, 3)).astype(np.float32)
    d[0, 0, 0, 2] = 0.0                              # the 1e-15 guard
    for g, w in zip(convert_to_ndc(o, d, 50.0, 16, 12),
                    jax_convert_to_ndc(o, d, 50.0, 16, 12)):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_ndc_rays_match_jax():
    c2w = np.stack([jpose.look_at(np.array([0.1 * i, 0.2, 1.0]),
                                  np.array([0, 1.0, 0]),
                                  np.array([0.3 * i, 0.1, -0.5]))
                    for i in range(3)]).astype(np.float32)
    rays = pinhole_rays(c2w, 12, 16, 13.0, 0.0, 1.0)
    _assert_rays_equal(ndc_rays(rays, 13.0, 16, 12, 0.0, 1.0),
                       jax_ndc_rays(rays, 13.0, 16, 12, 0.0, 1.0))


def _poses(n=6, seed=3):
    rng = np.random.default_rng(seed)
    out = np.zeros((n, 3, 5), np.float32)
    for i in range(n):
        out[i, :, :4] = jpose.look_at(rng.normal(size=3), np.array([0, 1.0, 0]),
                                      rng.normal(size=3))
        out[i, :, 4] = [12, 16, 20]
    return out


@pytest.mark.parametrize("name,args", [
    ("poses_avg", lambda: (_poses(),)),
    ("recenter_poses", lambda: (_poses(),)),
    ("spiral_path", lambda: (np.array([1.0, 0.5, 2.0], np.float32), 4.0, 7)),
    ("spherical_path", lambda: (3.0, 9, -20.0)),
    ("look_at", lambda: (np.array([0.3, 0.1, 1.0]), np.array([0, 1.0, 0]),
                         np.array([1.0, 2.0, 3.0]))),
])
def test_pose_functions_match_jax(name, args):
    a = args()
    got, want = getattr(pose, name)(*a), getattr(jpose, name)(*a)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_loaders_read_without_pil(llff_dir, blender_dir, monkeypatch):
    """With PIL gone the loaders read the PNGs with the port's own decoder
    and give the same arrays."""
    import sys

    cfgs = [DataConfig(dataset="llff", base_dir=llff_dir, factor=4,
                       use_ndc=False),
            DataConfig(dataset="blender", base_dir=blender_dir, factor=1)]
    want = [get_dataset(c, "train") for c in cfgs]
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    for c, w in zip(cfgs, want):
        _assert_same_dataset(get_dataset(c, "train"), w)


def test_jpeg_capture_without_pil_raises(tmp_path, llff_dir, monkeypatch):
    import shutil
    import sys

    shutil.copy(os.path.join(llff_dir, "poses_bounds.npy"), tmp_path)
    os.makedirs(tmp_path / "images_4")
    for i in range(10):
        Image.fromarray(np.zeros((12, 16, 3), np.uint8)).save(
            tmp_path / "images_4" / f"img_{i:03d}.jpg")
    cfg = DataConfig(dataset="llff", base_dir=str(tmp_path), factor=4)
    assert get_dataset(cfg, "test").n_images == 2        # PIL reads JPEG
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="PIL"):
        get_dataset(cfg, "test")


def test_capture_at_full_size_keeps_the_stage_mode_rule():
    """A capture of garden's size at factor 8 (185 views of 648x420, 161
    train) holds more train rays than the 2 GiB bank threshold, so
    train.stage_mode=auto stages from the host (the path the card run
    drives); 132 train views would still be above it."""
    from mipnerf360_torch.train import trainer

    class Stub:
        def __init__(self, n_views):
            self.n_rays = n_views * 648 * 420
            self.rays = [np.zeros((1, c), np.float32) for c in (3, 3, 3, 1, 1, 1)]
            self.pixels = np.zeros((1, 3), np.float32)

    from mipnerf360_torch.config import get_config

    cfg = get_config("garden_quality")
    assert cfg.train.stage_mode == "auto"
    assert not trainer.use_device_bank(cfg, Stub(161))
    assert not trainer.use_device_bank(cfg, Stub(132))
    assert trainer.use_device_bank(cfg, Stub(131))
    forced = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, stage_mode="device_bank"))
    assert trainer.use_device_bank(forced, Stub(161))
