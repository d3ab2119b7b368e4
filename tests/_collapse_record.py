"""The collapse record: what the one NeRF update that breaks ``parity_psnr
--mode convergence`` does to the NeRF trunk, and whether the shipped
presets collapse at other seeds.

    python tests/_collapse_record.py --out COLLAPSE_TORCH.json

On the card unless ``--device cpu``; the card's name and power limit, and
the torch and CUDA versions, are at the file's top level. Scenes and
checkpoints live in a temporary directory; only ``--out`` is written,
after each run (a cut run leaves what it had). Its sizes are the module's
constants; the tests shrink them by patching the module.

**Part A, the mechanism** (:data:`RUNS_A`). ``convergence``'s configuration
(the quality model, joint cadence, 4,096 rays, the exported 64x64 sphere,
the LR horizon of the record's 10,000 steps: ``tests/_spike_replay.py``'s
setup) at seeds 0-3, and ``llff_fern_quality`` at seed 0 (the preset
record's R4, on ``export_llff_scene(64, n_views=32)``) as a contrast, each
trained by ``train()``. Each run has windows ``(lo, hi)``: the *spike* is
the first step in the window whose ``loss_prop`` passes ``SPIKE``, else the
window's step of the largest ``loss_prop``; the *break* is the step before
it, whose update is examined. Seeds 0 and 1 break at 2,144 and 1,031
(``PERF.md`` section 6, the spike replay); seeds 2 and 3 are taken at both of those
steps (one-step windows); R4's spike is searched in steps 3,141-3,160.

The trainer's own loop is wrapped from outside (no option of the package):
after each chunk the wrapper keeps every step's train PSNR and
``loss_prop``, and every ``PROBE_EVERY`` steps takes the probe statistics
(the trajectory). At the last chunk boundary two steps or more before a
window it forks the state (its generator too) and takes the run's own next
steps on the fork (``_spike_replay.trainer_batch`` and
``grads_and_update``) through the window. For the break step it records,
from the state before the update and the state after it, on the step's own
batch (its noise, randomized) and on the probe batch (``PROBE_RAYS`` rays
of the train bank drawn once with ``PROBE_SEED``, deterministic):

- for each trunk layer and the density head: the share of units that are
  zero on every point (dead units), the share of zero (point, unit) pairs,
  and the 1st, 50th and 99th percentiles and the maximum of the
  pre-activation (:func:`unit_stats`);
- the density pre-activation (``raw + density_bias``) and its ``softplus``
  by the same percentiles, and the NeRF level's mean ``acc`` and rgb;
- per NeRF leaf the update's ||dW|| / ||W|| and largest |dW|;
- per trunk layer ||dh|| / ||h|| of its output, the trunk fed the before
  state's features of the batch in both states (``rel``), and with only
  that layer's update on the before state's input of that layer
  (``rel_own``).

The layers are seen by wrapping ``models/mlp.py::apply_linear`` and the
model's ``apply_mlp`` from outside (:class:`TrunkTap`). The self-check
(:data:`SELF_CHECK`): seed 0's ``loss_prop`` at step 2,145 and seed 1's at
1,032 lie within 1% of the spike replay's; if not, the record says so and
stops.

**Part B, the reach.** The preset record's R1, R2 and R3
(``mipnerf360_torch/tools/preset_record.py::run_one``, with ``--set
train.seed=N`` on every command) at seeds 1, 2 and 3, each with its
``collapsed`` flag (an image eval after step 500 more than 10 dB under the
best before it).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

from _spike_replay import (  # noqa: E402
    HORIZON, SPIKE, clone_state, grads_and_update, leaf_names, trainer_batch)
from mipnerf360_torch.apps.common import apply_overrides  # noqa: E402
from mipnerf360_torch.config import get_config  # noqa: E402
from mipnerf360_torch.core.rays import rays_map  # noqa: E402
from mipnerf360_torch.data import get_dataset  # noqa: E402
from mipnerf360_torch.models import mipnerf360 as model_mod  # noqa: E402
from mipnerf360_torch.models import mlp  # noqa: E402
from mipnerf360_torch.tools import preset_record  # noqa: E402
from mipnerf360_torch.tools.bench import card_name  # noqa: E402
from mipnerf360_torch.tools.parity_psnr import (  # noqa: E402
    _ours_cfg, export_blender_scene, export_llff_scene)
from mipnerf360_torch.train import trainer as trainer_mod  # noqa: E402
from mipnerf360_torch.train.state import leaves  # noqa: E402
from mipnerf360_torch.train.trainer import train, upload_bank  # noqa: E402

PROBE_RAYS = 4096
PROBE_SEED = 20_260_1014
PROBE_EVERY = 100
PERCENTILES = (1, 50, 99)
RES = 64
BATCH = 4096
# Part A: each run's seed, preset ("" for convergence) and windows.
RUNS_A = {
    "convergence_seed0": dict(seed=0, windows=[(2141, 2160)]),
    "convergence_seed1": dict(seed=1, windows=[(1031, 1050)]),
    "convergence_seed2": dict(seed=2, windows=[(1032, 1032), (2145, 2145)]),
    "convergence_seed3": dict(seed=3, windows=[(1032, 1032), (2145, 2145)]),
    "llff_fern_quality_seed0": dict(seed=0, preset="llff_fern_quality",
                                    windows=[(3141, 3160)]),
}
COLLAPSING = ("convergence_seed0", "convergence_seed1")
CONTROLS = ("convergence_seed2", "convergence_seed3")
# The spikes tests/_spike_replay.py recorded on the card (PERF.md section
# 6): run -> (step, loss_prop).
SELF_CHECK = {"convergence_seed0": (2145, 240_952.0),
              "convergence_seed1": (1032, 37_737.0)}
SELF_CHECK_RTOL = 0.01
PRESET_RUNS = ("R1", "R2", "R3")
PRESET_SEEDS = (1, 2, 3)

WHAT = ("The collapse record of the PyTorch port on one card: Part A, what "
        "the NeRF update that breaks parity_psnr --mode convergence (seeds "
        "0 and 1) does to the trunk, beside seeds 2 and 3 at the same steps "
        "and the hinge spike that llff_fern_quality survived (seed 0); "
        "Part B, the preset record's R1-R3 at seeds 1-3 with a collapsed "
        "flag. Written by tests/_collapse_record.py (see that file).")


def percentiles(x: torch.Tensor, qs=PERCENTILES) -> list:
    """``np.percentile(x, qs)`` (linear interpolation) of all of ``x``'s
    values, sorted on ``x``'s device and interpolated in float64."""
    s = torch.sort(x.detach().reshape(-1).float()).values
    n = s.numel()
    out = []
    for q in qs:
        pos = q / 100.0 * (n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        a, b = float(s[lo]), float(s[hi])
        out.append(a + (b - a) * (pos - lo))
    return out


def value_stats(x: torch.Tensor) -> dict:
    p = percentiles(x)
    return {f"p{q}": v for q, v in zip(PERCENTILES, p)} | {
        "max": float(x.max())}


def unit_stats(pre: torch.Tensor, post: torch.Tensor) -> dict:
    """A layer's statistics over the points of a batch: ``pre`` its
    pre-activation and ``post`` its output, [..., units] each."""
    zero = post.detach().reshape(-1, post.shape[-1]) == 0
    out = {"dead_units": int(zero.all(0).sum()) / zero.shape[1],
           "zero_pairs": int(zero.sum()) / zero.numel()}
    out.update({f"pre_{k}": v for k, v in value_stats(pre).items()})
    return out


class TrunkTap:
    """The NeRF trunk's and the density head's layer statistics in every
    forward run under :meth:`active`, seen by wrapping
    ``models/mlp.py::apply_linear`` and the model's ``apply_mlp`` from
    outside; the trunk and the head are told apart by their params.

    A layer's pre-activation is ``apply_linear``'s f32 result; its output
    the next layer's input (the last layer's: ``apply_mlp``'s result).
    ``keep``: also keep the trunk's input and each layer's output. While
    the tap is on, the tower takes that layer-by-layer chain on the card
    too, not the fused stack (``models/mlp.py::relu_stack_heads``), whose
    values are the same and whose layers no wrapper sees."""

    def __init__(self, nerf, density_bias: float, keep: bool = False):
        self.nerf, self.density_bias, self.keep = nerf, density_bias, keep
        self.trunk, self.head, self.density = [], None, None
        self.trunk_input, self.outputs = None, []
        self._pending = self._into = None

    def _close_layer(self, post):
        self._into.append(unit_stats(self._pending, post))
        if self.keep and self._into is self.trunk:
            self.outputs.append(post)
        self._pending = None

    @contextlib.contextmanager
    def active(self):
        orig_linear, orig_mlp = mlp.apply_linear, model_mod.apply_mlp

        def linear(layer, x, *args, **kw):
            y = orig_linear(layer, x, *args, **kw)
            if self._into is not None:
                if self._pending is not None:
                    self._close_layer(x)
                self._pending = y
            return y

        def apply_mlp(params, x, *args, **kw):
            nerf = self.nerf
            into = (self.trunk if params is nerf["trunk"] else [] if params
                    is nerf["density"] else None)
            if into is None:
                return orig_mlp(params, x, *args, **kw)
            if into is self.trunk:
                self.trunk.clear()
                self.outputs.clear()
                if self.keep:
                    self.trunk_input = x
            self._into = into
            try:
                out = orig_mlp(params, x, *args, **kw)
                self._close_layer(out)
            finally:
                self._into = self._pending = None
            if into is not self.trunk:
                self.head = into[0]
                z = out[..., 0] + self.density_bias
                self.density = {"pre": value_stats(z),
                                "softplus": value_stats(
                                    model_mod._softplus(z))}
            return out

        orig_fused = model_mod.fused_relu_stack
        mlp.apply_linear, model_mod.apply_mlp = linear, apply_mlp
        model_mod.fused_relu_stack = lambda *args: False
        try:
            yield self
        finally:
            mlp.apply_linear, model_mod.apply_mlp = orig_linear, orig_mlp
            model_mod.fused_relu_stack = orig_fused

    def stats(self) -> dict:
        return {"trunk": list(self.trunk), "density_head": self.head,
                "density": self.density}


def _dtype(cfg):
    return getattr(torch, cfg.model.compute_dtype)


def tower_stats(cfg, nerf, x) -> dict:
    """The tap's statistics of the trunk and the density head on NeRF-level
    features ``x``, through the model's ``apply_mlp`` as ``nerf_forward``
    calls it."""
    tap = TrunkTap(nerf, cfg.model.density_bias)
    head = ["sigmoid" if cfg.model.density_head_sigmoid else "none"]
    with torch.no_grad(), tap.active():
        feat = model_mod.apply_mlp(nerf["trunk"], x,
                                   model_mod._trunk_activations(cfg.model),
                                   _dtype(cfg))
        model_mod.apply_mlp(nerf["density"], feat, head, _dtype(cfg))
    return tap.stats()


def forward_stats(cfg, params, rays, randomized: bool, noise=None,
                  keep: bool = False):
    """(statistics, tap) of one forward of both levels under no_grad."""
    tap = TrunkTap(params["nerf"], cfg.model.density_bias, keep=keep)
    with torch.no_grad(), tap.active():
        out = model_mod.render_rays(params, cfg.model, rays, randomized,
                                    noise=noise)
    stats = tap.stats()
    stats["acc_mean"] = float(out["acc"].mean())
    stats["rgb_mean"] = [float(v) for v in out["rgb"].mean(0)]
    return stats, tap


def _rel(new, old) -> float:
    new, old = new.detach().float(), old.detach().float()
    den = float(torch.linalg.vector_norm(old))
    num = float(torch.linalg.vector_norm(new - old))
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def output_change(cfg, before, after, tap_before) -> list:
    """Per trunk layer, ||dh|| / ||h|| of its output: the after state's trunk
    on the before state's features (``rel``); the after state's layer alone
    on the before state's input of that layer (``rel_own``)."""
    acts = model_mod._trunk_activations(cfg.model)
    tap = TrunkTap(after["nerf"], cfg.model.density_bias, keep=True)
    with torch.no_grad(), tap.active():
        model_mod.apply_mlp(after["nerf"]["trunk"], tap_before.trunk_input,
                            acts, _dtype(cfg))
    out = []
    ins = [tap_before.trunk_input] + tap_before.outputs[:-1]
    pairs = zip(before["nerf"]["trunk"]["layers"],
                after["nerf"]["trunk"]["layers"])
    for i, ((lb, la), h_in) in enumerate(zip(pairs, ins)):
        with torch.no_grad():
            own = [mlp.apply_mlp({"layers": [layer]}, h_in, [acts[i]],
                                 _dtype(cfg)) for layer in (lb, la)]
        out.append({"rel": _rel(tap.outputs[i], tap_before.outputs[i]),
                    "rel_own": _rel(own[1], own[0])})
    return out


def update_stats(before, after) -> dict:
    """Per NeRF leaf, ||dW|| / ||W|| and the largest |dW| of the update."""
    names = leaf_names(before["nerf"], "nerf.")
    out = {}
    for n, b, a in zip(names, leaves(before["nerf"]), leaves(after["nerf"])):
        d = (a - b).detach().float()
        out[n] = {"rel_norm": _rel(a, b), "max_abs": float(d.abs().max())}
    return out


def examine(cfg, before, after, batch, probe) -> dict:
    """The break step's record from the states before and after it."""
    rays, _, noise = batch
    out = {"update": update_stats(before.params, after.params)}
    for where, args in (("batch", (rays, True, noise)),
                        ("probe", (probe, False, None))):
        sb, tb = forward_stats(cfg, before.params, *args, keep=True)
        sa, _ = forward_stats(cfg, after.params, *args)
        out[where] = {"before": sb, "after": sa,
                      "output_change": output_change(cfg, before.params,
                                                     after.params, tb)}
        del tb
    return out


def fork(state):
    """A copy of ``state`` whose generator continues where its own is."""
    dev = state.params["prop"]["layers"][0]["w"].device
    s = clone_state(state, dev)
    s.generator.set_state(state.generator.get_state())
    return s


def take_window(cfg, ds, bank, probe, state, lo: int, hi: int) -> dict:
    """The run's own steps on a fork of ``state`` through the window: the
    spike, the break step before it, and :func:`examine` of the break."""
    s = fork(state)
    kept, steps, spike, rule = {}, [], None, None
    while spike is None:
        k = s.step + 1
        b = trainer_batch(cfg, ds, bank, s, k)
        if k >= lo - 1:
            kept[k] = (clone_state(s, bank[1].device), b)
        _, aux, _ = grads_and_update(cfg, s, *b)
        steps.append({"k": k, **{x: aux[x] for x in (
            "loss_prop", "loss_nerf", "psnr", "lr")}})
        if k >= lo and aux["loss_prop"] > SPIKE:
            spike, rule = k, f"first loss_prop over {SPIKE}"
        elif k >= hi:
            window = [e for e in steps if e["k"] >= lo]
            spike = max(window, key=lambda e: e["loss_prop"])["k"]
            rule = ("the window's one step" if lo == hi else
                    f"no loss_prop over {SPIKE}: the window's largest")
    kb = spike - 1
    (before, batch), (after, _) = kept[kb], kept[spike]
    rec = {"window": [lo, hi], "spike": spike, "spike_rule": rule,
           "break_step": kb, "steps": steps,
           "loss_prop_at_spike": next(e["loss_prop"] for e in steps
                                      if e["k"] == spike)}
    rec.update(examine(cfg, before, after, batch, probe))
    return rec


class Tracker:
    """Wraps the trainer's loop from outside: the per-step train PSNR and
    ``loss_prop``, the probe trajectory, and the windows (each taken at the
    last chunk boundary at least two steps before it)."""

    def __init__(self, cfg, ds, bank, probe, windows, probe_every: int):
        self.cfg, self.ds, self.bank, self.probe = cfg, ds, bank, probe
        self.probe_every = probe_every
        chunk = max(1, cfg.train.log_every)
        self.points = {}
        for lo, hi in windows:
            at = (lo - 2) // chunk * chunk
            if at < chunk:
                raise ValueError(f"window {lo} lies before the first chunk")
            self.points.setdefault(at, []).append((lo, hi))
        self.psnr, self.loss_prop = [], []
        self.trajectory, self.windows = [], []

    @property
    def last_point(self) -> int:
        return max(self.points)

    def probe_entry(self, state) -> dict:
        stats, _ = forward_stats(self.cfg, state.params, self.probe, False)
        entry = {"step": state.step, "probe": stats}
        n = min(self.probe_every, len(self.psnr))
        if n:
            entry["window"] = {
                "steps": n,
                "train_psnr_mean": float(np.mean(self.psnr[-n:])),
                "loss_prop_mean": float(np.mean(self.loss_prop[-n:])),
                "loss_prop_max": float(np.max(self.loss_prop[-n:]))}
        return entry

    def after_chunk(self, state, aux):
        if aux is not None:
            self.psnr += aux["psnr"].float().cpu().tolist()
            self.loss_prop += aux["loss_prop"].float().cpu().tolist()
        if state.step % self.probe_every == 0:
            self.trajectory.append(self.probe_entry(state))
            print(json.dumps({"step": state.step, **self.trajectory[-1].get(
                "window", {}), "acc": self.trajectory[-1]["probe"][
                    "acc_mean"]}), flush=True)
        for lo, hi in self.points.get(state.step, []):
            t0 = time.time()
            rec = take_window(self.cfg, self.ds, self.bank, self.probe,
                              state, lo, hi)
            rec["seconds"] = round(time.time() - t0, 1)
            self.windows.append(rec)
            print(json.dumps({k: rec[k] for k in (
                "break_step", "spike", "spike_rule", "loss_prop_at_spike",
                "seconds")}), flush=True)

    @contextlib.contextmanager
    def installed(self):
        names = ("make_banked_train_loop", "make_train_loop")
        origs = {n: getattr(trainer_mod, n) for n in names}

        def wrap(make):
            def make_loop(*args, **kw):
                inner = make(*args, **kw)

                def loop(state, *a, **k):
                    if state.step == 0 and not self.trajectory:
                        self.after_chunk(state, None)
                    state, aux = inner(state, *a, **k)
                    self.after_chunk(state, aux)
                    return state, aux
                return loop
            return make_loop

        for n in names:
            setattr(trainer_mod, n, wrap(origs[n]))
        try:
            yield self
        finally:
            for n in names:
                setattr(trainer_mod, n, origs[n])


def run_config(spec, scene, ckpt):
    """A Part A run's Config: ``convergence``'s (as ``_spike_replay.py``
    builds it), or the preset's as ``apps.train --preset P --set
    data.base_dir=... --set data.factor=1`` builds it, its LR horizon held
    at the preset's own ``max_steps``."""
    seed = spec["seed"]
    if not spec.get("preset"):
        return _ours_cfg(scene, HORIZON, ckpt, cadence="joint",
                         batch_size=BATCH,
                         eval_image_every=HORIZON // 100, quality=True,
                         extra_train={"seed": seed, "lr_max_steps": HORIZON})
    cfg = apply_overrides(get_config(spec["preset"]), [
        f"data.base_dir={scene}", "data.factor=1",
        f"train.checkpoint_dir={ckpt}", f"train.seed={seed}",
        f"train.batch_size={BATCH}"])
    return apply_overrides(cfg, [f"train.lr_max_steps={cfg.train.max_steps}"])


def draw_probe(bank, n: int):
    """``n`` rays of the train bank, drawn once with ``PROBE_SEED``."""
    rays, _ = bank
    total = rays.origins.shape[0]
    idx = np.random.default_rng(PROBE_SEED).choice(total, min(n, total),
                                                   replace=False)
    idx = torch.as_tensor(np.sort(idx)).to(rays.origins.device)
    return rays_map(lambda x: x.index_select(0, idx), rays)


def part_a_run(name, spec, tmp: Path, device) -> dict:
    if spec.get("preset"):
        scene = tmp / f"llff_{RES}"
        if not scene.exists():
            export_llff_scene(str(scene), RES, n_views=32)
    else:
        scene = tmp / f"blender_{RES}"
        if not scene.exists():
            export_blender_scene(str(scene), RES)
    ckpt = tmp / name
    cfg = run_config(spec, str(scene), str(ckpt))
    ds = get_dataset(cfg.data, "train", white_bkgd=cfg.model.white_bkgd)
    bank = upload_bank(ds, device)
    probe = draw_probe(bank, PROBE_RAYS)
    tracker = Tracker(cfg, ds, bank, probe, spec["windows"], PROBE_EVERY)
    t0 = time.time()
    with tracker.installed():
        train(cfg, max_steps=tracker.last_point, device=device)
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"seed": spec["seed"], "preset": spec.get("preset") or
            "convergence (tools/parity_psnr.py _ours_cfg, joint, quality)",
            "lr_max_steps": cfg.train.lr_max_steps,
            "batch": cfg.train.batch_size, "res": RES,
            "probe_rays": int(probe.origins.shape[0]),
            "trained_to": tracker.last_point,
            "seconds": round(time.time() - t0, 1),
            "trajectory": tracker.trajectory, "windows": tracker.windows}


def self_check(name, section, expect) -> dict:
    step, want = expect
    got = next((e["loss_prop"] for w in section["windows"]
                for e in w["steps"] if e["k"] == step), None)
    ok = got is not None and abs(got - want) <= SELF_CHECK_RTOL * want
    return {"step": step, "loss_prop": got, "recorded_loss_prop": want,
            "rtol": SELF_CHECK_RTOL, "ok": bool(ok)}


def _flat(stats: dict) -> dict:
    """A probe's statistics as {name: value}."""
    out = {"acc_mean": stats["acc_mean"],
           "rgb_mean": float(np.mean(stats["rgb_mean"]))}
    for i, layer in enumerate(stats["trunk"]):
        out.update({f"trunk{i}.{k}": v for k, v in layer.items()})
    out.update({f"density_head.{k}": v
                for k, v in stats["density_head"].items()})
    for part, vals in stats["density"].items():
        out.update({f"density.{part}.{k}": v for k, v in vals.items()})
    return out


def precursors(part_a: dict) -> dict:
    """Which probe statistics separate the collapsing seeds from the
    controls before the break: at each step that all four trajectories
    hold, whether both collapsing seeds lie above both controls or below
    both (``separated``: the steps; ``from``: the earliest step from which
    every later common step separates), and at each collapsing seed's last
    probe whether it lies outside the controls' range at that step."""
    runs = COLLAPSING + CONTROLS
    if not all(r in part_a for r in runs):
        return {}
    traj = {r: {e["step"]: _flat(e["probe"])
                for e in part_a[r]["trajectory"]} for r in runs}
    common = sorted(set.intersection(*(set(t) for t in traj.values())))
    out = {"common_steps": common, "stats": {}}
    for key in traj[runs[0]][common[0]]:
        sep = []
        for step in common:
            col = [traj[r][step][key] for r in COLLAPSING]
            ctl = [traj[r][step][key] for r in CONTROLS]
            if min(col) > max(ctl) or max(col) < min(ctl):
                sep.append(step)
        since = None
        for step in reversed(common):
            if step not in sep:
                break
            since = step
        last = {}
        for r in COLLAPSING:
            step = max(traj[r])
            ctl = [traj[c][step][key] for c in CONTROLS if step in traj[c]]
            v = traj[r][step][key]
            last[r] = {"step": step, "outside": bool(
                ctl and (v > max(ctl) or v < min(ctl)))}
        if sep or all(x["outside"] for x in last.values()):
            out["stats"][key] = {"separated": sep, "from": since,
                                 "last_probe": last}
    return out


def break_summary(part_a: dict) -> dict:
    """Per examined update, on the probe: the trunk layer of the largest own
    output change and of the largest rise of dead units, and ``acc``."""
    out = {}
    for name, sec in part_a.items():
        for w in sec["windows"]:
            p = w["probe"]
            own = [c["rel_own"] for c in p["output_change"]]
            rise = [a["dead_units"] - b["dead_units"] for b, a in
                    zip(p["before"]["trunk"], p["after"]["trunk"])]
            out[f"{name}@{w['break_step']}"] = {
                "loss_prop_at_spike": w["loss_prop_at_spike"],
                "largest_rel_own_layer": int(np.argmax(own)),
                "rel_own": own,
                "rel": [c["rel"] for c in p["output_change"]],
                "largest_dead_rise_layer": int(np.argmax(rise)),
                "dead_rise": rise,
                "acc_mean": [p["before"]["acc_mean"], p["after"]["acc_mean"]],
                "density_pre_p99": [p["before"]["density"]["pre"]["p99"],
                                    p["after"]["density"]["pre"]["p99"]]}
    return out


def part_b(work: Path, device, card):
    """The preset record's :data:`PRESET_RUNS` at each of
    :data:`PRESET_SEEDS`: yields (key, section) as each ends."""
    args = argparse.Namespace(device=device, card=card)
    for seed in PRESET_SEEDS:
        seed_dir = work / f"seed{seed}"
        seed_dir.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, PATH=os.pathsep.join(
            [str(preset_record.python_shim_dir(seed_dir)),
             os.environ.get("PATH", "")]))
        for run in PRESET_RUNS:
            sec = preset_record.run_one(run, args, seed_dir, env,
                                        sets=(f"train.seed={seed}",))
            shutil.rmtree(seed_dir / preset_record.RUNS[run][0],
                          ignore_errors=True)
            sec["seed"] = seed
            sec["collapsed"] = sec["collapse"]["first_step"] is not None
            print(json.dumps({"run": run, "seed": seed,
                              "trajectory": sec["trajectory_mean_image_psnr"],
                              "collapsed": sec["collapsed"],
                              "wall_s": sec["wall_s"]}), flush=True)
            yield f"{run}_seed{seed}", sec


def run(out: str, device="cuda") -> dict:
    """The record into ``out`` (rewritten after every run); returns it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass --device cpu to run "
                         "on the CPU")
    t_start = time.time()
    rec = {"what": WHAT, "card": card_name(device),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "config": {"spike": SPIKE, "probe_rays": PROBE_RAYS,
                      "probe_seed": PROBE_SEED, "probe_every": PROBE_EVERY,
                      "percentiles": list(PERCENTILES),
                      "collapse_db": preset_record.COLLAPSE_DB,
                      "self_check_rtol": SELF_CHECK_RTOL}}

    def write():
        rec["seconds"] = round(time.time() - t_start, 1)
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)

    print(rec["card"], flush=True)
    with tempfile.TemporaryDirectory(prefix="collapse_record_") as tmp:
        tmp = Path(tmp)
        rec["part_a"], rec["self_check"] = {}, {}
        for name, spec in RUNS_A.items():
            print(f"part A: {name}", flush=True)
            rec["part_a"][name] = part_a_run(name, spec, tmp, device)
            if name in SELF_CHECK:
                chk = self_check(name, rec["part_a"][name], SELF_CHECK[name])
                rec["self_check"][name] = chk
                if not chk["ok"]:
                    write()
                    raise SystemExit(
                        f"self-check failed: {name} loss_prop at step "
                        f"{chk['step']} is {chk['loss_prop']}, not within "
                        f"{SELF_CHECK_RTOL:.0%} of {chk['recorded_loss_prop']}"
                        "; the record stops here")
            rec["break_summary"] = break_summary(rec["part_a"])
            rec["precursors"] = precursors(rec["part_a"])
            write()
        rec["part_b"] = {}
        for key, sec in part_b(tmp / "presets", device.type, rec["card"]):
            rec["part_b"][key] = sec
            rec["part_b_collapsed"] = sum(
                s["collapsed"] for s in rec["part_b"].values())
            write()
    write()
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return run(args.out, device=args.device)


if __name__ == "__main__":
    main()
