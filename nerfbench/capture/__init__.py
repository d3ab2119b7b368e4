"""The captures the cells train and render on, written from their
description in a configuration file: the analytic sphere of the port's
synthetic scene, shaded from cameras on a tilted orbit, in the LLFF layout
(``images_<factor>/NNN.png`` and ``poses_bounds.npy``) or the Blender layout
(``transforms_{train,test}.json`` and RGBA PNGs).

A frozen NumPy copy of the recipe of the port's ``chip_smoke.py``
(``write_llff_capture``, ``write_blender_capture``, with the scene of
``data/synthetic.py``); it imports nothing of the program. A capture is
written once per checkout under ``nerfbench/.cache/<name>/`` and reused by
every later run there: it stands for files a user already has on disk.
"""
from __future__ import annotations

import json
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .png import write_png

CACHE_DIR = Path(__file__).resolve().parents[1] / ".cache"
WORKERS = 4
_DONE = "DONE"


def _normalize(x):
    return x / np.linalg.norm(x)


def orbit_poses(angles, radius: float = 4.0, elevation: float = 0.5):
    """[n, 3, 4] camera-to-world of cameras on a tilted circle, looking at
    the origin (columns right, up, back, position)."""
    poses = []
    for th in angles:
        pos = np.array([radius * np.cos(th), radius * np.sin(th),
                        radius * elevation * np.sin(th * 2 + 1.0)])
        back = _normalize(pos)
        right = _normalize(np.cross(np.array([0.0, 0.0, 1.0]), back))
        up = _normalize(np.cross(back, right))
        poses.append(np.stack([right, up, back, pos], 1))
    return np.stack(poses, 0).astype(np.float32)


def orbit_angles(n: int) -> np.ndarray:
    return np.linspace(0, 2 * np.pi, n + 1)[:-1]


def shade_sphere(c2w: np.ndarray, h: int, w: int, focal: float,
                 background: float = 0.0) -> np.ndarray:
    """[h, w, 3] float32 render of a lambertian unit sphere at the origin,
    normal-coded albedo, seen by the pinhole camera ``c2w`` [3, 4]."""
    x, y = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    cam = np.stack([(x - w * 0.5 + 0.5) / focal, -(y - h * 0.5 + 0.5) / focal,
                    -np.ones_like(x)], -1)
    d = cam @ c2w[:3, :3].T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(c2w[:3, 3], d.shape)
    b = np.sum(o * d, -1)
    disc = b * b - (np.sum(o * o, -1) - 1.0)
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit = (disc > 0) & (t > 0)
    p = o + t[..., None] * d
    n = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
    light = _normalize(np.array([0.5, 0.5, 0.8]))
    lambert = np.clip(np.sum(n * light, -1), 0.0, 1.0)
    rgb = 0.5 * (n + 1.0) * (0.25 + 0.75 * lambert[..., None])
    return np.where(hit[..., None], rgb, background).astype(np.float32)


def _to_u8(rgb):
    return np.clip(rgb * 255 + 0.5, 0, 255).astype(np.uint8)


def write_llff(out: Path, views: int, width: int, height: int,
               factor: int) -> None:
    """``images_<factor>/NNN.png`` of width x height, black background, and
    ``poses_bounds.npy``: rotation columns [-up, right, back], position,
    [h, w, focal] at ``factor`` times the written size, and depth bounds
    that bracket the sphere."""
    focal = 0.9 * width
    poses = orbit_poses(orbit_angles(views))
    img_dir = out / f"images_{factor}"
    img_dir.mkdir(parents=True)

    def write(i):
        rgb = shade_sphere(poses[i], height, width, focal)
        write_png(img_dir / f"{i:03d}.png", _to_u8(rgb))

    with ThreadPoolExecutor(WORKERS) as pool:
        list(pool.map(write, range(views)))
    rows = []
    for pose in poses:
        right, up, back, t = pose.T
        hwf = np.array([height * factor, width * factor, focal * factor],
                       np.float64)
        d = float(np.linalg.norm(t))
        rows.append(np.concatenate([
            np.stack([-up, right, back, t, hwf], axis=1).reshape(-1),
            [d - 1.3, d + 2.0]]))
    np.save(out / "poses_bounds.npy", np.asarray(rows, np.float64))


def blender_splits(n_train: int, n_test: int):
    """{split: orbit positions}: the held-out views interleave with the
    train views on one orbit of n_train + n_test cameras."""
    n_total = n_train + n_test
    test = sorted(set(np.linspace(0, n_total, n_test, endpoint=False)
                      .astype(int).tolist()))
    return {"train": [i for i in range(n_total) if i not in test],
            "test": test}


def write_blender(out: Path, train: int, test: int, res: int) -> None:
    """``transforms_{train,test}.json`` and res x res RGBA PNGs, alpha 255
    on the sphere and 0 around it."""
    focal = 0.9 * res
    poses = orbit_poses(orbit_angles(train + test))
    splits = blender_splits(train, test)
    jobs = [(s, j, i) for s, idx in splits.items() for j, i in enumerate(idx)]

    def write(job):
        split, j, i = job
        rgb = shade_sphere(poses[i], res, res, focal)
        # no lit sphere pixel is black: the albedo 0.5 * (n + 1) never is
        alpha = np.where(rgb.any(-1, keepdims=True), 255, 0).astype(np.uint8)
        write_png(out / split / f"r_{j}.png",
                  np.concatenate([_to_u8(rgb), alpha], -1))

    for split in splits:
        (out / split).mkdir(parents=True)
    with ThreadPoolExecutor(WORKERS) as pool:
        list(pool.map(write, jobs))
    for split, idx in splits.items():
        frames = []
        for j, i in enumerate(idx):
            c2w = np.eye(4)
            c2w[:3, :4] = poses[i]
            frames.append({"file_path": f"{split}/r_{j}",
                           "transform_matrix": c2w.tolist()})
        with open(out / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": float(2 * np.arctan(0.5 * res / focal)),
                       "frames": frames}, f)


WRITERS = {"llff": write_llff, "blender": write_blender}


def ensure(spec: dict, cache_dir: Path = CACHE_DIR):
    """The directory of the capture ``spec`` (a configuration's
    ``capture``: ``name``, ``layout`` and the writer's sizes), written
    first if this checkout has none. Returns (path, seconds spent
    writing, 0 when it was there)."""
    out = Path(cache_dir) / spec["name"]
    if (out / _DONE).is_file():
        return out, 0.0
    t0 = time.perf_counter()
    partial = out.with_name(out.name + ".partial")
    shutil.rmtree(partial, ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)
    partial.mkdir(parents=True)
    sizes = {k: v for k, v in spec.items() if k not in ("name", "layout")}
    WRITERS[spec["layout"]](partial, **sizes)
    (partial / _DONE).write_text(json.dumps(spec))
    partial.rename(out)
    return out, time.perf_counter() - t0
