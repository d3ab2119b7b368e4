"""The reference's inputs, worked out from the capture's files: the rays of
any pixel from the camera poses, the pixel colours from the PNGs, and the
trainer's batch selection (the stateless splitmix64 index stream).

Plain NumPy. It reads the capture and nothing that the program made; the
conventions are those of the datasets' own loaders (LLFF: poses_bounds.npy
axes swapped to [right, up, back], scaled so the nearest bound is 4/3,
recentred on the average pose, every 8th view held out, metric near/far
from the bounds; Blender: transforms JSON, half resolution by a 2x2 box
filter, alpha over white).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..capture.png import read_png

def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def batch_indices(seed: int, step: int, batch: int, n_rays: int) -> np.ndarray:
    """The flat ray indices of train step ``step``: draw j of the stream is
    splitmix64(seed ^ splitmix64(step * batch + j)) mod n_rays."""
    with np.errstate(over="ignore"):
        c = np.arange(step * batch, (step + 1) * batch, dtype=np.uint64)
        h = _splitmix64(np.uint64(seed & (2**64 - 1)) ^ _splitmix64(c))
    return (h % np.uint64(n_rays)).astype(np.int64)


def _normalize(x):
    return x / np.linalg.norm(x)


def _recenter(poses):
    """The loader's recentring, in its own float32 steps: the orbit of a
    synthetic capture makes the average pose's axes sums that nearly
    cancel, so its rounding decides the frame, and the rays follow it."""
    center = poses[:, :3, 3].mean(0)
    back = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    right = _normalize(np.cross(up, back))
    c2w = np.stack([right, _normalize(np.cross(back, right)), back, center], 1)
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = np.concatenate([c2w, bottom], -2)
    homo = np.concatenate(
        [poses[:, :3, :4], np.tile(np.reshape(bottom, [1, 1, 4]),
                                   [poses.shape[0], 1, 1])], -2)
    out = poses.copy()
    out[:, :3, :4] = (np.linalg.inv(c2w) @ homo)[:, :3, :4]
    return out


class Capture:
    """One split of a capture: ``c2w`` [n, 3, 4], image size, focal,
    near/far, ray shape inputs, and the image files."""

    def __init__(self, root, data: dict, split: str, white_bkgd: bool):
        root = Path(root)
        self.white_bkgd = white_bkgd
        self.factor = data["factor"]
        if data["dataset"] == "blender":
            self._blender(root, split, data["near"], data["far"])
        elif data["dataset"] in ("llff", "nerf_360"):
            if data.get("use_ndc", True):
                raise ValueError("the reference has metric LLFF rays only")
            self._llff(root, split)
        else:
            raise ValueError(f"no reference loader for {data['dataset']!r}")
        self._images = {}

    def _llff(self, root: Path, split: str):
        arr = np.load(root / "poses_bounds.npy")
        files = sorted(p for p in (root / f"images_{self.factor}").iterdir()
                       if p.suffix.lower() == ".png")
        h, w = read_png(files[0]).shape[:2]
        poses = arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
        bds = arr[:, -2:].transpose([1, 0])
        focal = poses[2, 4, 0] / self.factor
        # stored rotation columns [down, right, back] -> [right, up, back]
        poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :],
                                poses[:, 2:, :]], 1)
        poses = np.moveaxis(poses, -1, 0).astype(np.float32)
        bds = np.moveaxis(bds, -1, 0).astype(np.float32)
        scale = 1.0 / (bds.min() * 0.75)
        poses[:, :3, 3] *= scale
        bds *= scale
        poses = _recenter(poses)[:, :3, :4].astype(np.float64)
        test = np.arange(len(poses))[::8]
        idx = test if split == "test" else np.setdiff1d(np.arange(len(poses)),
                                                        test)
        self.c2w = poses[idx]
        self.files = [files[i] for i in idx]
        self.h, self.w, self.focal = h, w, float(focal)
        self.near, self.far = float(bds.min() * 0.9), float(bds.max())
        self.layout = "llff"

    def _blender(self, root: Path, split: str, near: float, far: float):
        meta = json.loads((root / f"transforms_{split}.json").read_text())
        frames = meta["frames"]
        self.files = [root / (f["file_path"] + ".png") for f in frames]
        self.c2w = np.array([f["transform_matrix"] for f in frames],
                            np.float64)[:, :3, :4]
        full = read_png(self.files[0]).shape[:2]
        div = 2 if self.factor >= 2 else 1
        self.h, self.w = full[0] // div, full[1] // div
        self.focal = float(0.5 * self.w / np.tan(0.5 * meta["camera_angle_x"]))
        self.near, self.far = float(near), float(far)
        self.layout = "blender"

    @property
    def n_views(self) -> int:
        return len(self.files)

    @property
    def n_rays(self) -> int:
        return self.n_views * self.h * self.w

    def _dirs(self, view, y, x):
        cam = np.stack([(x - self.w * 0.5 + 0.5) / self.focal,
                        -(y - self.h * 0.5 + 0.5) / self.focal,
                        -np.ones_like(x, dtype=np.float64)], -1)
        return np.einsum("nij,nj->ni", self.c2w[view, :, :3], cam)

    def rays(self, flat) -> dict:
        """Rays of flat pixel indices (view-major, then row, then column):
        origins, directions, viewdirs [n, 3], radii, near, far [n, 1],
        float32. The radius is the distance to the next row's direction
        (the last row takes the one above's) times 2 / sqrt(12)."""
        flat = np.asarray(flat, np.int64)
        per = self.h * self.w
        view, pix = flat // per, flat % per
        y, x = (pix // self.w).astype(np.float64), (pix % self.w).astype(np.float64)
        d = self._dirs(view, y, x)
        y0 = np.minimum(y, self.h - 2)
        dr = np.linalg.norm(self._dirs(view, y0, x) - self._dirs(view, y0 + 1, x),
                            axis=-1)
        ones = np.ones((len(flat), 1))
        out = {"origins": self.c2w[view, :, 3],
               "directions": d,
               "viewdirs": d / np.linalg.norm(d, axis=-1, keepdims=True),
               "radii": dr[:, None] * 2.0 / np.sqrt(12.0),
               "near": ones * self.near, "far": ones * self.far}
        return {k: v.astype(np.float32) for k, v in out.items()}

    def _image(self, view: int) -> np.ndarray:
        img = self._images.get(view)
        if img is None:
            img = read_png(self.files[view]).astype(np.float32) / 255.0
            if self.layout == "blender":
                if self.factor >= 2:
                    img = 0.25 * (img[0::2, 0::2] + img[1::2, 0::2]
                                  + img[0::2, 1::2] + img[1::2, 1::2])
                if self.white_bkgd:
                    img = img[..., :3] * img[..., 3:] + (1.0 - img[..., 3:])
            img = np.ascontiguousarray(img[..., :3])
            self._images[view] = img
        return img

    def pixels(self, flat) -> np.ndarray:
        """[n, 3] float32 colours of flat pixel indices."""
        flat = np.asarray(flat, np.int64)
        per = self.h * self.w
        out = np.empty((len(flat), 3), np.float32)
        views = flat // per
        for v in np.unique(views):
            sel = views == v
            pix = flat[sel] % per
            out[sel] = self._image(int(v))[pix // self.w, pix % self.w]
        return out
