"""Render traffic: whole held-out views through the program's
``render_image``, one after another, as ``trainer.evaluate_image`` and
``apps.eval`` render them: the preset's ``eval_image_chunk`` rays at a
time, with rgb, distance and acc copied to the host.

The weights are the benchmark's, from the seed (the cost of a view does
not depend on them: the sample counts are fixed and nothing ends early);
the order of the views is a permutation drawn from the seed, cycled.
``warmup_views`` views are rendered in set-up. The check draws
``check_rays`` rays from the seed over the views that closed inside the
window and holds the program's answers for them to the reference's.
"""
from __future__ import annotations

import itertools
import math
import time

import numpy as np

from nerfbench import weights
from nerfbench.reference import model as ref
from nerfbench.reference import rays as ref_rays


def _widest(prog: dict, want: dict, far: float) -> dict:
    """Widest gaps over the checked rays: rgb (any channel), acc, and acc *
    distance (the expected depth, defined where acc is small) over far."""
    def widest(a, b):
        return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))

    return {"rgb": widest(prog["rgb"], want["rgb"]),
            "acc": widest(prog["acc"], want["acc"]),
            "depth": widest(prog["acc"] * prog["distance"],
                            want["acc"] * want["distance"]) / far}


def gap_readings(prog: dict, want: dict, want_bf16: dict, far: float) -> dict:
    """``<output>_gap``: the program's widest gap from the float32
    reference, in units of the widest gap of the reference computed with
    bfloat16 matrix products (the configuration's precision) on the same
    rays and weights. About 1 for a program that rounds as the
    configuration states; the raw gaps are ``<output>_widest``."""
    got, unit = _widest(prog, want, far), _widest(want_bf16, want, far)
    out = {f"{k}_gap": got[k] / max(unit[k], 1e-30) for k in got}
    out.update({f"{k}_widest": v for k, v in got.items()})
    return out


class Driver:
    kind = "render"

    def __init__(self, cell, cfg, capture_dir, device):
        from mipnerf360_torch.data import get_dataset

        self.cell, self.cfg, self.device = cell, cfg, device
        self.capture_dir = capture_dir
        self.mix = cell.mix
        self.chunk = cfg.train.eval_image_chunk
        self.dataset = get_dataset(cfg.data, "test",
                                   white_bkgd=cfg.model.white_bkgd)
        self.per_view = self.dataset.h * self.dataset.w
        self.attempted = self.failed = 0

    def start(self, seed: int) -> None:
        self.seed = seed
        self.params = weights.make_params(self.cell.config["model"], seed,
                                          self.device)
        order = np.random.default_rng(weights.stream_seed(seed, 3)).permutation(
            self.dataset.n_images)
        self.order = itertools.cycle(order.tolist())
        self.done = []          # (view, {rgb, distance, acc} on the host)

    def _view(self):
        from mipnerf360_torch.models.mipnerf360 import render_image

        i = next(self.order)
        rays, _ = self.dataset.image(i)
        out = render_image(self.params, self.cfg.model, rays,
                           chunk=self.chunk, device=self.device)
        host = dict(zip(("rgb", "distance", "acc"),
                        (x.cpu().numpy() for x in out)))
        return i, host

    def warm(self) -> None:
        for _ in range(self.mix["warmup_views"]):
            self._view()

    def views(self, n: int) -> None:
        """Render ``n`` views and keep them for the check (calibration)."""
        for _ in range(n):
            self.done.append(self._view())

    def window(self, seconds: float):
        t0 = time.perf_counter()
        closes = []
        while time.perf_counter() - t0 < seconds:
            i, host = self._view()
            t = time.perf_counter()
            self.attempted += 1
            self.failed += int(not all(np.isfinite(v).all()
                                       for v in host.values()))
            if t - t0 <= seconds:
                closes.append(t)
                self.done.append((i, host))
        if not closes:
            raise RuntimeError(f"no view closed in {seconds} s")
        span = closes[-1] - t0
        rays = len(closes) * self.per_view
        return ({"render_rays_per_s": rays / span},
                {"rays": rays, "seconds": span, "rate": rays / span,
                 "view_s": np.diff([t0] + closes).tolist()})

    def segment(self) -> dict:
        """The traced segment: ``profile_views`` more views."""
        for _ in range(self.mix["profile_views"]):
            self._view()
        return {"views": self.mix["profile_views"],
                "rays": self.mix["profile_views"] * self.per_view,
                "composite": {"K1": [self.chunk,
                                     self.cell.config["model"]["num_samples"]]}}

    def stop(self) -> None:
        """Nothing to free: the kept views are what the check reads."""

    def release(self) -> None:
        del self.dataset

    def readings(self, matmul: str = "", fault: str = "",
                 detail: bool = False) -> dict:
        """The program's answers for ``check_rays`` rays drawn from the seed
        over the views kept, against the float32 reference's, by
        :func:`gap_readings`. With ``matmul`` (the control runs), the
        reference in that precision takes the program's place."""
        ref.strict_float32()
        conf = self.cell.config
        rng = np.random.default_rng(weights.stream_seed(self.seed, 4))
        pos = rng.integers(0, len(self.done), self.mix["check_rays"])
        pix = rng.integers(0, self.per_view, self.mix["check_rays"])
        views = np.array([self.done[p][0] for p in pos])
        prog = {k: np.stack([self.done[p][1][k][q] for p, q in zip(pos, pix)])
                for k in ("rgb", "distance", "acc")}
        cap = ref_rays.Capture(self.capture_dir, conf["data"], "test",
                               conf["model"]["white_bkgd"])
        rays = ref.to_device(cap.rays(views * self.per_view + pix), self.device)

        def render(precision):
            out = ref.render(conf["model"], self.params, rays,
                             self.chunk, precision)
            return {k: v.cpu().numpy() for k, v in out.items()}

        want, want_bf16 = render("float32"), render("bfloat16")
        if matmul:
            prog = render(matmul)
        elif fault:
            raise ValueError(f"unknown fault {fault!r}")
        out = gap_readings(prog, want, want_bf16, cap.far)
        return {k: (float("inf") if isinstance(v, float) and not math.isfinite(v)
                    else v) for k, v in out.items()}
