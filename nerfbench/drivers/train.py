"""Training traffic: the trainer's chunk loop at the configuration's batch
and cadence, as ``mipnerf360_torch.train.trainer.train`` runs it.

The stage mode resolves as the trainer's (``use_device_bank``), then the
bank is uploaded or the host gathers; ``make_banked_train_loop`` or
``make_train_loop`` runs each chunk of K steps, fed by ``stage_chunk``
through a ``BackgroundStager`` of ``stage_depth``, and each chunk ends in
one transfer of its losses to the host. Evals and saves are off (the mix
says so), and ``train()`` itself is not called: it cannot stop at a time
limit.

The weights and the noise generator are the benchmark's, from the seed;
the batch stream is the trainer's stateless one under the same seed. The
first steps run as chunks of ``CHECK_CHUNKS`` (1, then 2) through the same
loop and staging, so that the program's state can be read after step 1
(its first gradient, from the AdamW moment: only a first chunk of one step
leaves the gradient alone in it) and after step 3 (the change of its
parameters); then warm-up to ``warmup_steps``, then the window, in chunks
of the preset's ``log_every`` steps, aligned to multiples of it.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from nerfbench import weights
from nerfbench.reference import model as ref
from nerfbench.reference import rays as ref_rays

CHECK_CHUNKS = (1, 2)
CHECK_STEPS = sum(CHECK_CHUNKS)
PARTS = ("loss_nerf", "loss_dist", "loss_prop")


def _unit_gap(prog: dict, want: dict, keep) -> float:
    """Median, over the output units (columns) of every weight matrix in
    ``keep``, of the gap between the program's and the reference's norm of
    that unit's column, against the larger of the reference's norm and
    the median unit's of that matrix."""
    gaps = []
    for k in keep:
        b = want[k]
        if b.ndim != 2:
            continue
        cp, cr = torch.linalg.norm(prog[k], dim=0), torch.linalg.norm(b, dim=0)
        gaps.append((cp - cr).abs() / torch.clamp(cr, min=float(cr.median())))
    return float(torch.cat(gaps).median())


def gap_readings(prog: dict, want: dict, want_bf16: dict, params0: dict,
                 dist_weight: float, detail: bool = False) -> dict:
    """The numbers compared with the reference. ``loss_gap``: the largest
    relative gap, over the steps, of the NeRF level's loss (30 - PSNR plus
    the weighted distortion loss; the distillation hinge is left out: its
    bound jumps where a resampled edge crosses a proposal edge, and it
    divides by the proposal weight + 1e-6). ``grad_gap``: the first
    gradient, by :func:`_unit_gap` over every weight matrix;
    ``grad_gap_prop``: the same over the proposal MLP's matrices alone,
    whose gradient only the distillation loss feeds (they are about a
    ninth of the units, too few to move ``grad_gap``), in units of that
    gap of ``want_bf16``, the reference with bfloat16 products (the
    configuration's precision): from seed to seed the raw gap moves four
    times over, for the program and ``want_bf16`` alike, and the unit
    takes that out (the raw gap is ``grad_gap_prop_raw``). ``delta_gap``:
    the worst leaf's gap between the norms of the change of the
    parameters after the steps, against the larger of the reference's
    norm of that leaf and of the median leaf. Leaves whose reference gradient is under a thousandth of
    the median leaf's are left out (they move by round-off alone). Also,
    for the calibration: the total loss's gap ``total_loss_gap``, the worst
    leaf's gradient gap ``grad_leaf_gap``, the unit median of the change
    ``delta_unit_gap``, and with ``detail`` the worst leaves, the leaves
    left out and each step's loss terms."""
    def nerf_loss(parts):
        return [q["loss_nerf"] + dist_weight * q["loss_dist"] for q in parts]

    rel = lambda a, b: abs(a - b) / abs(b)
    loss_gap = max(map(rel, nerf_loss(prog["parts"]), nerf_loss(want["parts"])))
    p0 = dict(weights.leaves(params0))
    g_ref = {k: float(torch.linalg.norm(v)) for k, v in want["grad1"].items()}
    g_med = float(np.median(list(g_ref.values())))
    keep = [k for k, v in g_ref.items() if v >= 1e-3 * g_med]

    def worst(norm_p, norm_r):
        med = float(np.median([norm_r[k] for k in keep]))
        return max((abs(norm_p[k] - norm_r[k]) / max(norm_r[k], med), k)
                   for k in keep)

    dp = {k: prog["params"][k] - p0[k] for k in keep}
    dr = {k: want["params"][k] - p0[k] for k in keep}
    g_prog = {k: float(torch.linalg.norm(prog["grad1"][k])) for k in keep}
    d_prog = {k: float(torch.linalg.norm(dp[k])) for k in keep}
    d_ref = {k: float(torch.linalg.norm(dr[k])) for k in keep}
    (grad_leaf_gap, grad_leaf), (delta_gap, delta_leaf) = (
        worst(g_prog, g_ref), worst(d_prog, d_ref))
    prop = [k for k in keep if k.startswith("prop.")]
    prop_raw = _unit_gap(prog["grad1"], want["grad1"], prop)
    prop_unit = _unit_gap(want_bf16["grad1"], want["grad1"], prop)
    out = {"loss_gap": loss_gap,
           "grad_gap": _unit_gap(prog["grad1"], want["grad1"], keep),
           "grad_gap_prop": prop_raw / max(prop_unit, 1e-30),
           "grad_gap_prop_raw": prop_raw,
           "delta_gap": delta_gap,
           "total_loss_gap": max(map(rel, prog["losses"], want["losses"])),
           "grad_leaf_gap": grad_leaf_gap,
           "delta_unit_gap": _unit_gap(dp, dr, keep)}
    if detail:
        out.update(grad_leaf=grad_leaf, delta_leaf=delta_leaf, left_out=sorted(
            set(g_ref) - set(keep)))
        for part in ("loss_nerf", "loss_dist", "loss_prop"):
            out[part] = [[a[part], b[part]] for a, b in
                         zip(prog["parts"], want["parts"])]
    return out


class Driver:
    kind = "train"

    def __init__(self, cell, cfg, capture_dir, device):
        from mipnerf360_torch.data import get_dataset
        from mipnerf360_torch.train import trainer
        from mipnerf360_torch.train.step import (make_banked_train_loop,
                                                 make_train_loop)

        self.cell, self.cfg, self.device = cell, cfg, device
        self.capture_dir = capture_dir
        self.mix = cell.mix
        self.trainer = trainer
        self.batch = cfg.train.batch_size
        self.dataset = get_dataset(cfg.data, "train",
                                   white_bkgd=cfg.model.white_bkgd)
        self.bank = (trainer.upload_bank(self.dataset, device)
                     if trainer.use_device_bank(cfg, self.dataset) else None)
        self.loop = (make_banked_train_loop(cfg) if self.bank is not None
                     else make_train_loop(cfg))
        self.attempted = self.failed = 0

    def _starts(self):
        chunk, end = self.cfg.train.log_every, self.cfg.train.max_steps
        starts = [0]
        for k in CHECK_CHUNKS:
            starts.append(starts[-1] + k)
        starts += list(range(-(-starts[-1] // chunk) * chunk, end, chunk))
        return starts, dict(zip(starts, starts[1:] + [end]))

    def _stage(self, at):
        k = self.ends[at] - at
        return k, self.trainer.stage_chunk(
            self.dataset, self.bank, self.device, k, self.batch, self.seed, at)

    def _chunk(self):
        """One chunk through the loop, ending in one transfer of its losses;
        returns (steps, {name: [K] host tensor})."""
        staged = self.stager.get()
        if staged is None:
            raise RuntimeError("the schedule ran out of steps")
        k, args = staged
        self.state, aux = self.loop(self.state, *args)
        names = [n for n, v in aux.items() if v.device.type == self.device.type]
        vals = torch.stack([aux[n].float() for n in names]).cpu()
        self.step += k
        return k, dict(zip(names, vals))

    def start(self, seed: int) -> None:
        """Build the state from the seed and run the first CHECK_STEPS
        steps, keeping what the check reads."""
        from mipnerf360_torch.train.state import B1, make_train_state

        self.seed = seed
        model = self.cell.config["model"]
        self.params0 = weights.make_params(model, seed, self.device)
        self.state = make_train_state(
            self.params0, device=self.device,
            generator=weights.noise_generator(seed, self.device))
        starts, self.ends = self._starts()
        self.stager = self.trainer.BackgroundStager(
            self._stage, starts, depth=self.trainer.stage_depth(self.bank))
        self.step, losses, parts = 0, [], []
        while self.step < CHECK_STEPS:
            k, vals = self._chunk()
            losses += vals["loss"].tolist()
            parts += [{n: float(vals[n][i]) for n in PARTS} for i in range(k)]
            if self.step == CHECK_CHUNKS[0]:
                mu = {"prop": self.state.opt_state["prop"].mu,
                      "nerf": self.state.opt_state["nerf"].mu}
                grad1 = {n: v.detach() / (1 - B1) for n, v in weights.leaves(mu)}
        self.program = {
            "losses": losses[:CHECK_STEPS], "parts": parts[:CHECK_STEPS],
            "grad1": grad1,
            "params": {n: v.detach().clone()
                       for n, v in weights.leaves(self.state.params)}}

    def warm(self) -> None:
        while self.step < self.mix["warmup_steps"]:
            self._chunk()

    def window(self, seconds: float):
        """Chunks until ``seconds`` have passed; the rate counts the rays of
        the chunks that closed inside the window over the time from its
        opening to the last of those closings."""
        t0 = time.perf_counter()
        closes, rays = [], 0
        while time.perf_counter() - t0 < seconds:
            k, vals = self._chunk()
            t = time.perf_counter()
            self.attempted += k
            self.failed += int((~torch.isfinite(vals["loss"])).sum())
            if t - t0 <= seconds:
                closes.append(t)
                rays += k * self.batch
        if not closes:
            raise RuntimeError(f"no chunk closed in {seconds} s")
        span = closes[-1] - t0
        chunk_s = np.diff([t0] + closes).tolist()
        return ({"train_rays_per_s": rays / span},
                {"rays": rays, "seconds": span, "rate": rays / span,
                 "chunk_s": chunk_s})

    def segment(self) -> dict:
        """The traced segment: ``profile_chunks`` more chunks."""
        steps = 0
        for _ in range(self.mix["profile_chunks"]):
            k, _ = self._chunk()
            steps += k
        n = self.cell.config["model"]["num_samples"]
        return {"steps": steps, "rays": steps * self.batch,
                "composite": {"K1": [self.batch, n], "K2": [self.batch, n]}}

    def stop(self) -> None:
        """Stop the stager and free the program's state."""
        self.stager.close()
        del self.state, self.stager

    def release(self) -> None:
        """:meth:`stop`, and free the loop and the data."""
        self.stop()
        del self.loop, self.bank, self.dataset

    def _reference_batches(self):
        conf = self.cell.config
        cap = ref_rays.Capture(self.capture_dir, conf["data"], "train",
                               conf["model"]["white_bkgd"])
        out = []
        for step in range(CHECK_STEPS):
            idx = ref_rays.batch_indices(self.seed, step, self.batch, cap.n_rays)
            out.append((ref.to_device(cap.rays(idx), self.device),
                        torch.as_tensor(cap.pixels(idx), device=self.device)))
        return out

    def readings(self, matmul: str = "", fault: str = "",
                 detail: bool = False) -> dict:
        """The program's first steps against the float32 reference's. With
        ``matmul`` or ``fault`` (the control runs), the reference in that
        precision, or with that fault planted, takes the program's place.
        ``detail``: see :func:`gap_readings`."""
        ref.strict_float32()
        conf = self.cell.config
        batches = self._reference_batches()

        def steps(precision, drop_half=False):
            return ref.train_steps(
                conf["model"], conf["train"], self.params0, batches,
                weights.noise_generator(self.seed, self.device), precision,
                drop_half=drop_half)

        def named(out):
            out["parts"] = [{n: s[n] for n in PARTS} for s in out["losses"]]
            out["losses"] = [s["loss"] for s in out["losses"]]
            return out

        want, want_bf16 = named(steps("float32")), named(steps("bfloat16"))
        if matmul or fault == "drop_half":
            prog = named(steps(matmul or "float32",
                               drop_half=fault == "drop_half"))
        elif fault == "unchanged":
            prog = dict(want, params=dict(weights.leaves(self.params0)))
        elif fault:
            raise ValueError(f"unknown fault {fault!r}")
        else:
            prog = self.program
        out = gap_readings(prog, want, want_bf16, self.params0,
                           conf["train"]["dist_loss_weight"], detail)
        return {k: (float("inf") if isinstance(v, float) and not math.isfinite(v)
                    else v) for k, v in out.items()}
