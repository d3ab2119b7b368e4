"""The card half of the spike replay: reproduce a proposal-distillation
spike of ``parity_psnr --mode convergence`` from its own trajectory, log it,
and replay each of its steps under other numeric paths.
``tests/_spike_replay_jax.py`` is its JAX half (row e).

    python tests/_spike_replay.py --seed 0 --start 2140 --out DIR
    python tests/_spike_replay.py --seed 0 --start 2140 --out DIR --nerf-moments
    python tests/_spike_replay.py --seed 1 --start 1030 --out DIR

It trains ``convergence``'s configuration (the quality model, joint
cadence, 4,096 rays, the exported 64x64 sphere, the LR horizon of the
record's 10,000 steps) with ``train()`` to ``--start`` and keeps the state
in memory. Then it takes the run's own next steps (the trainer's batches,
the noise drawn from the state's generator as the step would) until the
first whose ``loss_prop`` passes SPIKE (the spike; at most MAX_STEPS), and
AFTER more. It logs each step ``k`` (row a, the run itself): the losses;
per params leaf the largest |g|, the L2 of g, the largest Adam ``nu`` and
|update|; the proposal's and the NeRF's density range; the least ``w_prop +
1e-6``; the samples with ``bound - w_prop > 0.5`` and ``w_prop < 1e-4``;
the rays of the largest hinge; and every non-finite value.

From the state before each step up to the spike it also takes that one
step in other rows, on the same batch and noise, and compares it with row a
(the losses; per leaf the relative L2 of the gradient):

- ``b``: the composite in its plain PyTorch version on the card (autograd
  through ``core/rendering.py``), not K1/K2;
- ``c``: cuBLAS with ``allow_bf16_reduced_precision_reduction`` off;
- ``d``: the CPU (the plain composite, f32 products of the bf16 operands);
- ``t``: the TPU kernels' arithmetic for the composite, in plain PyTorch
  on the card (:class:`TpuComposite`);
- ``p``: every f32 einsum of the step (the bound's overlap product, the
  encoding's projections) as a TPU computes it at XLA's default precision:
  its operands, and the gradients that reach them, rounded to bf16, the
  products summed in f32 (:func:`einsum_one_bf16_pass`).

Then every row (and row a) runs from the first state through the spike (the
rollout). On the CPU only rows d and t run.

``DIR`` gets ``replay.json`` (everything above), ``fixture_<k>.npz`` (the 64
rays of the largest hinge of step k: rays, pixels, noise, both levels'
t_vals, densities and weights, the bound) and ``state_<k>.npz`` for the
step k before the spike, the one whose update broke the run: its params,
the proposal's Adam moments and counters, and the noise of steps k and k+1.
From that state ``replay.json``'s ``held`` holds the losses of step k+1
after only one subtree's update of step k, the other held at its params
before k, and after each NeRF leaf's update alone. ``--nerf-moments`` takes the run to the same state and writes,
instead of all that, the NeRF's Adam moments there (``nerf_moments_<k>.npz``,
61 MB at full width; ``state_<k>.npz`` is 38 MB, so each run's output stays
under 64 MiB). The JAX half needs both for its own step from that state.
Each file carries the SHA-256 of the state's params, so the JAX half checks
that the two runs reached the same state. Checkpoints and the scene go to a
temporary directory.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mipnerf360_torch.core.rays import Rays, rays_map  # noqa: E402
from mipnerf360_torch.data import get_dataset  # noqa: E402
from mipnerf360_torch.losses.distillation import weight_bounds  # noqa: E402
from mipnerf360_torch.models.mipnerf360 import (  # noqa: E402
    RenderNoise, draw_render_noise, map_params)
from mipnerf360_torch.ops import composite  # noqa: E402
from mipnerf360_torch.tools.bench import card_name  # noqa: E402
from mipnerf360_torch.tools.parity_psnr import (  # noqa: E402
    _ours_cfg, export_blender_scene)
from mipnerf360_torch.train import step as step_mod  # noqa: E402
from mipnerf360_torch.train.state import (  # noqa: E402
    AdamState, TrainState, apply_updates_subtree, leaves, make_train_state)
from mipnerf360_torch.train.trainer import train, upload_bank  # noqa: E402

EPS = 1e-6           # the hinge's eps (losses/distillation.py)
HORIZON = 10_000     # the LR horizon: the recorded run's length
SUB = 64             # rays of the largest hinge kept per step
SPIKE = 10.0         # loss_prop above this is the spike (the band's limit)
MAX_STEPS = 12       # steps replayed at most, looking for the spike
AFTER = 5            # steps of row a logged after the spike
ROWS = ("b", "c", "d", "t", "p")
CPU_ROWS = ("d", "t")  # b, c and p are card paths


def leaf_names(tree, prefix: str = "") -> list:
    """Names of a params tree's leaves, in :func:`leaves` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _tpu_terms(density, t_vals, dirs):
    """The TPU kernel's forward arithmetic: delta, dd, T as exp of minus
    (inclusive prefix - dd), and alpha by a 3-term Taylor series under
    dd = 1e-2 (``mipnerf360_tpu/ops/pallas/composite.py:35-56``)."""
    delta = (t_vals[..., 1:] - t_vals[..., :-1]) * torch.linalg.norm(
        dirs, dim=-1, keepdim=True)
    dd = density * delta
    trans = torch.exp(-(torch.cumsum(dd, -1) - dd))
    taylor = dd * (1.0 - dd * 0.5 * (1.0 - dd * (1.0 / 3.0)))
    alpha = torch.where(dd < 1e-2, taylor, 1.0 - torch.exp(-dd))
    return delta, dd, trans, alpha


class TpuComposite(torch.autograd.Function):
    """Row t: the TPU kernels' arithmetic in plain PyTorch, forward and
    backward (the suffix sum as total - inclusive prefix, ``:59-74``)."""

    @staticmethod
    def forward(ctx, density, t_vals, dirs):
        ctx.save_for_backward(density, t_vals, dirs)
        _, _, trans, alpha = _tpu_terms(density, t_vals, dirs)
        return alpha * trans

    @staticmethod
    def backward(ctx, g):
        delta, dd, trans, alpha = _tpu_terms(*ctx.saved_tensors)
        gw = g * alpha * trans
        suffix = torch.sum(gw, -1, keepdim=True) - torch.cumsum(gw, -1)
        return (g * torch.exp(-dd) * trans - suffix) * delta, None, None


class Recorder:
    """Records each composite of a forward (density, t_vals, weights; the
    proposal's first, the NeRF's second); computes it as ``row`` says: row
    b's plain PyTorch version, row t's TPU arithmetic, else the port's
    (K1/K2 on the card)."""

    def __init__(self, row: str = "a"):
        self.row, self.calls = row, []

    @contextlib.contextmanager
    def active(self):
        orig = composite.composite_weights

        def fn(density, t_vals, dirs):
            if self.row == "b":
                w = composite.plain_composite_weights(density, t_vals, dirs)
            elif self.row == "t":
                w = TpuComposite.apply(density, t_vals, dirs)
            else:
                w = orig(density, t_vals, dirs)
            self.calls.append((density.detach(), t_vals.detach(), w.detach()))
            return w

        composite.composite_weights = fn
        try:
            yield self
        finally:
            composite.composite_weights = orig


@contextlib.contextmanager
def no_reduced_precision_reduction():
    """Row c: cuBLAS bf16 GEMMs without reduced-precision reductions."""
    m = torch.backends.cuda.matmul
    old = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = old


@contextlib.contextmanager
def einsum_one_bf16_pass():
    """Row p: ``torch.einsum`` on float32 operands rounds them to bf16 and
    sums the products in f32, as XLA's default precision does on a TPU (one
    bf16 pass). The rounding's backward rounds the gradient that reaches
    each operand to bf16 as well."""
    orig = torch.einsum

    def einsum(eq, *ops):
        ops = [o.to(torch.bfloat16).float()
               if isinstance(o, torch.Tensor) and o.dtype == torch.float32
               else o for o in ops]
        return orig(eq, *ops)

    torch.einsum = einsum
    try:
        yield
    finally:
        torch.einsum = orig


def row_context(row: str):
    if row == "c":
        return no_reduced_precision_reduction()
    if row == "p":
        return einsum_one_bf16_pass()
    return contextlib.nullcontext()


def clone_state(state: TrainState, device) -> TrainState:
    """A copy of ``state`` on ``device`` (the generator stays behind: a
    replayed step takes explicit noise)."""
    copy = lambda t: t.detach().to(device, copy=True)
    opt = {k: AdamState(a.count, map_params(copy, a.mu),
                        map_params(copy, a.nu))
           for k, a in state.opt_state.items()}
    return make_train_state(map_params(copy, state.params), device=device,
                            generator=torch.Generator(device), step=state.step,
                            sched_count=state.sched_count, opt_state=opt)


def state_device(state) -> torch.device:
    return state.params["prop"]["layers"][0]["w"].device


def trainer_batch(cfg, ds, bank, state, k: int):
    """Step k's batch (the trainer's, from ``bank`` on the card) and noise
    (drawn from ``state``'s generator, as the step would)."""
    bank_rays, bank_pix = bank
    device = bank_pix.device
    idx = torch.as_tensor(ds.index_stack(1, cfg.train.batch_size,
                                         cfg.train.seed, k - 1)[0])
    idx = idx.long().to(device)
    noise = draw_render_noise(state.generator, cfg.train.batch_size,
                              cfg.model.num_samples, device)
    return (rays_map(lambda x: x.index_select(0, idx), bank_rays),
            bank_pix.index_select(0, idx), noise)


def grads_and_update(cfg, state, rays, pixels, noise, recorder=None,
                     subtrees=("prop", "nerf")):
    """One joint step of ``state`` in place, updating ``subtrees``: (grads
    of both, aux, update per updated leaf as params before minus after)."""
    with (recorder.active() if recorder else contextlib.nullcontext()):
        grads, aux = step_mod.joint_cadence_grads(cfg, state, rays, pixels,
                                                  noise=noise)
    before = [p.detach().clone() for k in subtrees
              for p in leaves(state.params[k])]
    lr = step_mod._lr(cfg.train, state.sched_count)
    for k in subtrees:
        apply_updates_subtree(state.params[k], grads[k], state.opt_state[k],
                              lr, cfg.train.weight_decay)
    after = [p.detach() for k in subtrees for p in leaves(state.params[k])]
    state.step += 1
    state.sched_count += 1
    aux = {k: float(v) for k, v in aux.items()}
    aux["lr"] = float(lr)
    return grads["prop"] + grads["nerf"], aux, [a - b for a, b in
                                                zip(before, after)]


def leaf_stats(names, grads, state, updates) -> dict:
    nus = [n for k in ("prop", "nerf") for n in leaves(state.opt_state[k].nu)]
    return {n: {"g_max": float(g.abs().max()), "g_l2": float(g.norm()),
                "nu_max": float(nu.max()), "update_max": float(u.abs().max())}
            for n, g, nu, u in zip(names, grads, nus, updates)}


def rel_l2(a, b) -> float:
    """|a - b| / |b| over one leaf (in f64; 0 where both are 0)."""
    a, b = a.double().cpu(), b.double().cpu()
    den = float(b.norm())
    num = float((a - b).norm())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def compare(names, grads, aux, ref_grads, ref_aux) -> dict:
    rels = {n: rel_l2(g, r) for n, g, r in zip(names, grads, ref_grads)}
    worst = max(rels, key=lambda n: rels[n])
    return {"loss": aux["loss"], "loss_prop": aux["loss_prop"],
            "loss_nerf": aux["loss_nerf"],
            "loss_prop_rel": abs(aux["loss_prop"] - ref_aux["loss_prop"])
            / max(abs(ref_aux["loss_prop"]), 1e-30),
            "loss_rel": abs(aux["loss"] - ref_aux["loss"])
            / max(abs(ref_aux["loss"]), 1e-30),
            "grad_rel_l2_max": rels[worst], "grad_rel_l2_worst_leaf": worst,
            "grad_rel_l2": rels,
            "g_max": max(float(g.abs().max()) for g in grads)}


def regime(rec: Recorder) -> tuple:
    """The spike's regime from one forward's two composites, the SUB rays
    of the largest hinge, and the bound."""
    (dp, tp, wp), (dn, tn, wn) = rec.calls[:2]
    bound = weight_bounds(tn, wn, tp)
    hinge = torch.clamp(bound - wp, min=0.0) ** 2 / (wp + EPS)
    per_ray = hinge.sum(-1)
    top = torch.topk(per_ray, min(SUB, per_ray.shape[0])).indices
    flags = (bound - wp > 0.5) & (wp < 1e-4)
    nonfinite = {name: int((~torch.isfinite(x)).sum())
                 for name, x in (("density_prop", dp), ("w_prop", wp),
                                 ("density_nerf", dn), ("w_nerf", wn))}
    return {"density_prop_min": float(dp.min()),
            "density_prop_max": float(dp.max()),
            "density_nerf_min": float(dn.min()),
            "density_nerf_max": float(dn.max()),
            "w_prop_plus_eps_min": float((wp + EPS).min()),
            "samples_bound_gt_w_by_0.5_and_w_lt_1e-4": int(flags.sum()),
            "rays_with_such_samples": int(flags.any(-1).sum()),
            "hinge_max_ray": float(per_ray.max()),
            "hinge_top_rays": [[int(i), float(per_ray[i])] for i in top],
            "nonfinite": nonfinite}, top, bound


def fixture_arrays(rec, rays, pixels, noise, top, bound) -> dict:
    (dp, tp, wp), (dn, tn, wn) = rec.calls[:2]
    pick = lambda x: x.detach()[top].cpu().numpy()
    out = {f"rays_{f}": pick(x) for f, x in zip(Rays._fields, rays)}
    out.update(pixels=pick(pixels), noise_sample=pick(noise.sample),
               noise_resample=pick(noise.resample), dirs=pick(rays.directions),
               t_prop=pick(tp), density_prop=pick(dp), w_prop=pick(wp),
               t_nerf=pick(tn), density_nerf=pick(dn), w_nerf=pick(wn),
               bound=pick(bound), ray_index=top.cpu().numpy())
    return out


def _to(device, rays, pixels, noise):
    mv = lambda x: x.to(device)
    return (rays_map(mv, rays), mv(pixels),
            RenderNoise(mv(noise.sample), mv(noise.resample)))


def run_row(cfg, state, batch, row, subtrees=("prop", "nerf")):
    """One step of ``row`` on a copy of ``state``: (copy, grads, aux)."""
    dev = "cpu" if row == "d" else state_device(state)
    s = clone_state(state, dev)
    with row_context(row):
        g, aux, _ = grads_and_update(cfg, s, *_to(dev, *batch),
                                     Recorder(row), subtrees)
    return s, g, aux


def replay_rows(cfg, names, state, batch, ref_grads, ref_aux, rows) -> dict:
    """The one-step rows from ``state`` (left untouched), each against row
    a's gradients and losses."""
    out = {}
    for row in rows:
        t0 = time.time()
        _, g, aux = run_row(cfg, state, batch, row)
        out[row] = compare(names, g, aux, ref_grads, ref_aux)
        out[row]["seconds"] = round(time.time() - t0, 3)
    return out


def rollout(cfg, state, batches, row) -> list:
    """``loss_prop`` and ``loss_nerf`` of each step of ``row`` from
    ``state`` over ``batches``."""
    dev = "cpu" if row == "d" else state_device(state)
    s, losses = clone_state(state, dev), []
    for b in batches:
        with row_context(row):
            _, aux, _ = grads_and_update(cfg, s, *_to(dev, *b), Recorder(row))
        losses.append({"loss_prop": aux["loss_prop"],
                       "loss_nerf": aux["loss_nerf"]})
    return losses


def params_sha256(arrays: list) -> np.ndarray:
    """The SHA-256 of params' float32 bytes, in :func:`leaf_names` order."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a, np.float32).tobytes())
    return np.frombuffer(h.digest(), np.uint8)


def moments_arrays(state, sub: str) -> dict:
    """``sub``'s Adam moments as NumPy, keyed ``mu.<leaf>``/``nu.<leaf>``."""
    a = state.opt_state[sub]
    return {f"{part}.{n}": t.detach().cpu().numpy()
            for part in ("mu", "nu")
            for n, t in zip(leaf_names(a.mu, f"{sub}."),
                            leaves(getattr(a, part)))}


def state_arrays(state, noises) -> dict:
    """Params, the proposal's Adam moments, the counters and ``noises``
    (the whole batch's, of step k and k+1) as NumPy."""
    names = leaf_names(state.params)
    arr = {f"params.{n}": p.detach().cpu().numpy()
           for n, p in zip(names, leaves(state.params))}
    arr.update(moments_arrays(state, "prop"))
    arr["counts"] = counts(state)
    arr["params_sha256"] = params_sha256(
        [arr[f"params.{n}"] for n in names])
    for i, nz in enumerate(noises):
        arr[f"noise_sample_{i}"] = nz.sample.cpu().numpy()
        arr[f"noise_resample_{i}"] = nz.resample.cpu().numpy()
    return arr


def counts(state) -> np.ndarray:
    return np.array([state.step, state.sched_count,
                     state.opt_state["prop"].count,
                     state.opt_state["nerf"].count], np.int64)


def held_losses(cfg, names, state, batches) -> dict:
    """Losses of step k+1 (``batches[1]``) after step k's update of one
    subtree alone, the other held at its params before k; then of each
    NeRF leaf's update alone (every other param held)."""
    out, updated = {}, {}
    losses = lambda aux: {x: float(aux[x]) for x in ("loss_prop",
                                                     "loss_nerf")}
    for sub in ("prop", "nerf"):
        s, _, _ = run_row(cfg, state, batches[0], "a", (sub,))
        updated[sub] = [p.detach().clone() for p in leaves(s.params[sub])]
        _, aux, _ = grads_and_update(cfg, s, *batches[1])
        out[f"{sub}_only"] = losses(aux)
    s = clone_state(state, state_device(state))
    out["nerf_leaf"] = {}
    for name, p, new in zip([n for n in names if n.startswith("nerf.")],
                            leaves(s.params["nerf"]), updated["nerf"]):
        old = p.detach().clone()
        with torch.no_grad():
            p.copy_(new)
        _, aux = step_mod.joint_cadence_grads(cfg, s, *batches[1][:2],
                                              noise=batches[1][2])
        out["nerf_leaf"][name] = losses(aux)
        with torch.no_grad():
            p.copy_(old)
    return out


def run(seed: int, start: int, out: str, device: str = "cuda",
        batch_size: int = 4096, res: int = 64, model: dict = None,
        max_steps: int = MAX_STEPS, nerf_moments: bool = False) -> dict:
    device = torch.device(device)
    rows = list(CPU_ROWS if device.type == "cpu" else ROWS)
    os.makedirs(out, exist_ok=True)
    report = {"card": card_name(device), "seed": seed, "start": start,
              "batch": batch_size, "res": res, "horizon": HORIZON,
              "rows": rows, "steps": []}
    with tempfile.TemporaryDirectory(prefix="spike_replay_") as tmp:
        scene = export_blender_scene(os.path.join(tmp, "scene"), res)
        cfg = _ours_cfg(scene, HORIZON, os.path.join(tmp, "ckpt"),
                        cadence="joint", batch_size=batch_size,
                        eval_image_every=HORIZON // 100, quality=True,
                        extra_model=model,
                        extra_train={"seed": seed, "lr_max_steps": HORIZON})
        report["model"] = dataclasses.asdict(cfg.model)
        t0 = time.time()
        state = train(cfg, max_steps=start, device=device)
        report["train_s"] = round(time.time() - t0, 1)
        print(f"trained to {state.step} in {report['train_s']} s", flush=True)
        ds = get_dataset(cfg.data, "train", white_bkgd=True)
        bank_rays, bank_pix = upload_bank(ds, device)
        names = (leaf_names(state.params["prop"], "prop.")
                 + leaf_names(state.params["nerf"], "nerf."))

        def next_batch(k):
            return trainer_batch(cfg, ds, (bank_rays, bank_pix), state, k)

        # row a: the run's own steps, logged, to the spike and AFTER more;
        # the state before each step up to the spike kept for the rows
        batches, before, records, spike = [], [], [], None
        while spike is None or len(batches) < len(before) + AFTER:
            k = state.step + 1
            b = next_batch(k)
            batches.append(b)
            replayed = spike is None
            if replayed:
                before.append(clone_state(state, device))
            rec = Recorder()
            g, aux, upd = grads_and_update(cfg, state, *b, rec)
            reg, top, bound = regime(rec)
            report["steps"].append({
                "k": k, "a": aux, "regime": reg,
                "leaves": leaf_stats(names, g, state, upd),
                "nonfinite_grads": sum(int((~torch.isfinite(x)).sum())
                                       for x in g)})
            print(json.dumps({"k": k, "loss_prop": aux["loss_prop"],
                              "loss_nerf": aux["loss_nerf"],
                              "hinge_max_ray": reg["hinge_max_ray"]}),
                  flush=True)
            if replayed:
                records.append((g, aux))
                if not nerf_moments:
                    np.savez(os.path.join(out, f"fixture_{k}.npz"),
                             **fixture_arrays(rec, *b, top, bound))
                if aux["loss_prop"] > SPIKE or len(before) == max_steps:
                    spike = k
            del rec, g, upd
        report["spike"] = spike
        # the step that broke the run (the one before the spike)
        ib = max(len(before) - 2, 0)
        kb = before[ib].step + 1
        if nerf_moments:
            arr = moments_arrays(before[ib], "nerf")
            arr["counts"] = counts(before[ib])
            arr["params_sha256"] = params_sha256(
                [p.detach().cpu().numpy() for p in leaves(before[ib].params)])
            np.savez(os.path.join(out, f"nerf_moments_{kb}.npz"), **arr)
            print(f"the NeRF's moments before step {kb} written", flush=True)
            return report
        for i, s in enumerate(before):
            k = s.step + 1
            t0 = time.time()
            entry = next(e for e in report["steps"] if e["k"] == k)
            entry["rows"] = replay_rows(cfg, names, s, batches[i],
                                        *records[i], rows)
            print(f"rows of step {k} in {time.time() - t0:.1f} s: " +
                  json.dumps({r: {"loss_prop": v["loss_prop"],
                                  "grad_rel_l2_max": v["grad_rel_l2_max"]}
                              for r, v in entry["rows"].items()}), flush=True)
        report["rollout"] = {"a": [{"loss_prop": e["a"]["loss_prop"],
                                    "loss_nerf": e["a"]["loss_nerf"]}
                                   for e in report["steps"][:len(before)]]}
        for row in rows:
            t0 = time.time()
            report["rollout"][row] = rollout(cfg, before[0],
                                             batches[:len(before)], row)
            print(f"rollout {row} in {time.time() - t0:.1f} s: " +
                  json.dumps([r["loss_prop"] for r in report["rollout"][row]]),
                  flush=True)
        report["held"] = dict(k=kb, **held_losses(cfg, names, before[ib],
                                                  batches[ib:ib + 2]))
        held = report["held"]
        worst = sorted(held["nerf_leaf"].items(),
                       key=lambda x: -x[1]["loss_nerf"])[:3]
        print(f"held: the losses of step {kb + 1} after step {kb}'s update "
              f"of the proposal alone {held['prop_only']}, of the NeRF alone "
              f"{held['nerf_only']}; of one NeRF leaf alone, the largest "
              f"loss_nerf: {worst}", flush=True)
        np.savez(os.path.join(out, f"state_{kb}.npz"),
                 **state_arrays(before[ib], [batches[ib][2],
                                             batches[ib + 1][2]]))
        report["state_saved"] = kb
    with open(os.path.join(out, "replay.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--start", type=int, default=2140)
    ap.add_argument("--out", required=True)
    ap.add_argument("--nerf-moments", action="store_true",
                    help="write only the NeRF's Adam moments before the "
                         "step that broke the run")
    args = ap.parse_args(argv)
    return run(args.seed, args.start, args.out,
               nerf_moments=args.nerf_moments)


if __name__ == "__main__":
    main()
