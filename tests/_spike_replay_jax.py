"""Row e of the spike replay: the JAX package's joint step from the card's
state, against the port's step on the CPU (row d) from the same state.

    JAX_PLATFORMS=cpu python tests/_spike_replay_jax.py DIR [--full]

``DIR`` is what ``tests/_spike_replay.py`` wrote on the card:
``state_<k>.npz`` (the params before step k, the step whose update broke
the run, the proposal's Adam moments and counters, and the noise of steps
k and k+1), ``nerf_moments_<k>.npz`` (the NeRF's Adam moments there, from
its ``--nerf-moments`` run; both carry the SHA-256 of the params, which
must agree), ``fixture_<k>.npz`` (the rays of the largest hinge of step k,
with their pixels and noise) and ``replay.json``.

On the fixture's rays:

- the JAX package's ``joint_cadence_step``, under ``jax.jit``, with
  ``use_pallas="on"`` (the TPU kernel in interpret mode, its own math) and
  ``"off"`` (jnp autodiff), the card's noise put in place of its
  ``jax.random.uniform`` draws; its gradients are read from the first
  moment of a zeroed optimizer state (``mu = (1 - b1) g``), its update
  from a second call with the card's moments;
- the port's ``joint_cadence_grads`` and update on the CPU, the same
  rays, noise and state;
- per leaf the relative L2 of row e's gradient against row d's, the
  losses, and the update of the params (before minus after) by relative
  L2 and its largest entry-wise difference.

``--full`` takes step k over its whole batch (regenerated from the exported
scene and the stateless index stream, its noise from ``state_<k>.npz``) in
each package, in chunks of ``--chunk`` rays: the losses and the gradient of
every leaf (the photometric loss is 30 minus the PSNR of the batch's MSE,
so a first pass over the chunks finds that MSE and the second weighs each
chunk's squared error by its derivative), then the package's own AdamW
update of both subtrees from the card's moments (the JAX package's
``make_optimizer`` and ``apply_updates_subtree``; the port's), then the
losses of step k+1 on its whole batch from the updated params: each
package's own step k, not the card's, reaches step k+1.
``--compute-dtype float32`` runs both packages' MLPs in float32 on the
same state, which takes the bf16 rounding out of the comparison. Writes
``DIR/row_e.json`` (``row_e_float32.json`` with ``--compute-dtype
float32``). The state is the full-width quality model, so only small
batches run here: the fixture's 64 rays, or one chunk at a time.
"""
import argparse
import contextlib
import functools
import json
import os
import sys
import tempfile
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _spike_replay import leaf_names, params_sha256  # noqa: E402
from mipnerf360_tpu.config import Config as JConfig  # noqa: E402
from mipnerf360_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from mipnerf360_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from mipnerf360_tpu.core.rays import Rays as JRays  # noqa: E402
from mipnerf360_tpu.losses.distillation import \
    distillation_loss as jax_distillation  # noqa: E402
from mipnerf360_tpu.losses.distortion import \
    distortion_loss as jax_distortion  # noqa: E402
from mipnerf360_tpu.train import state as jstate  # noqa: E402
from mipnerf360_tpu.train import step as jstep  # noqa: E402
from mipnerf360_torch import interop  # noqa: E402
from mipnerf360_torch.config import (QUALITY_TRAIN, Config,  # noqa: E402
                                     ModelConfig, TrainConfig)
from mipnerf360_torch.core.rays import Rays  # noqa: E402
from mipnerf360_torch.losses.distillation import \
    distillation_loss  # noqa: E402
from mipnerf360_torch.losses.distortion import distortion_loss  # noqa: E402
from mipnerf360_torch.models import mipnerf360 as tm  # noqa: E402
from mipnerf360_torch.train import step as tstep  # noqa: E402
from mipnerf360_torch.train.state import (  # noqa: E402
    AdamState, apply_updates_subtree, leaves, make_train_state)

B1 = 0.9


def configs(run: dict, mode: str):
    """Both packages' configs of the replayed run (``replay.json``)."""
    m = dict(run["model"], use_pallas=mode)
    t = dict(QUALITY_TRAIN, max_steps=run["horizon"],
             lr_max_steps=run["horizon"], batch_size=run["batch"],
             cadence="joint", seed=run["seed"])
    return (JConfig(model=JModelConfig(**m), train=JTrainConfig(**t)),
            Config(model=ModelConfig(**m), train=TrainConfig(**t)))


def _set(tree, path, value):
    keys = [int(p) if p.isdigit() else p for p in path.split(".")]
    for k in keys[:-1]:
        tree = tree[k]
    tree[keys[-1]] = value


def load_state(d: str, model: ModelConfig):
    """(k, port state before step k, [noise of step k, of step k+1]) from
    ``state_<k>.npz`` and, where it is there, ``nerf_moments_<k>.npz`` (else
    the NeRF's moments are zeros and None is returned for the state)."""
    (k,) = [int(f[6:-4]) for f in os.listdir(d)
            if f.startswith("state_") and f.endswith(".npz")]
    z = dict(np.load(os.path.join(d, f"state_{k}.npz")))
    path = os.path.join(d, f"nerf_moments_{k}.npz")
    m = dict(np.load(path)) if os.path.exists(path) else {}
    params = tm.init_model(model)
    names = leaf_names(params)
    digest = params_sha256([z[f"params.{n}"] for n in names])
    assert np.array_equal(digest, z["params_sha256"]), "state_<k> is damaged"
    if m:
        assert np.array_equal(m["params_sha256"], digest) and np.array_equal(
            m["counts"], z["counts"]), "the NeRF's moments are of another state"
    moments = {sub: [tm.map_params(torch.zeros_like, params[sub])
                     for _ in range(2)] for sub in ("prop", "nerf")}
    for name, a in dict(z, **m).items():
        head, _, path = name.partition(".")
        t = torch.from_numpy(np.array(a, np.float32))
        if head == "params":
            _set(params, path, t)
        elif head in ("mu", "nu"):
            sub, _, leaf = path.partition(".")
            _set(moments[sub][head == "nu"], leaf, t)
    noises = [(z[f"noise_sample_{i}"], z[f"noise_resample_{i}"])
              for i in (0, 1)]
    return k, port_state(params, moments, z["counts"]), noises, bool(m)


def port_state(params, moments, counts, zero_moments=False):
    """The port's state from params, {subtree: [mu, nu]} and the counters
    (step, sched_count, the two Adam counts)."""
    state = make_train_state(params, device="cpu",
                             generator=torch.Generator(),
                             step=int(counts[0]), sched_count=int(counts[1]))
    if not zero_moments:
        for i, sub in enumerate(("prop", "nerf")):
            mu, nu = moments[sub]
            state.opt_state[sub] = AdamState(int(counts[2 + i]),
                                             tm.map_params(torch.clone, mu),
                                             tm.map_params(torch.clone, nu))
    return state


def jax_state(state):
    tree = interop.train_state_to_numpy_tree(state)
    arr = functools.partial(jax.tree.map, jnp.asarray)
    opt = {k: (optax.ScaleByAdamState(count=jnp.asarray(a.count),
                                      mu=arr(a.mu), nu=arr(a.nu)),
               optax.EmptyState())
           for k, (a, _) in tree.opt_state.items()}
    return jstate.TrainState(step=jnp.asarray(tree.step),
                             sched_count=jnp.asarray(tree.sched_count),
                             params=arr(tree.params), opt_state=opt,
                             key=jax.random.PRNGKey(0))


def pallas_mode(mode: str):
    """The TPU kernel in interpret mode for ``use_pallas="on"`` (as the JAX
    package's own tests run it on the CPU)."""
    return (pltpu.force_tpu_interpret_mode() if mode == "on"
            else contextlib.nullcontext())


@contextlib.contextmanager
def injected_noise(sample, resample):
    """The JAX forward's two ``jax.random.uniform`` draws (the proposal's
    edges, then the stratified resample) replaced by the card's."""
    queue = [jnp.asarray(sample), jnp.asarray(resample)]
    orig = jax.random.uniform

    def fake(key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0):
        x = queue.pop(0)
        assert tuple(x.shape) == tuple(shape), (x.shape, shape)
        return x

    jax.random.uniform = fake
    try:
        yield
    finally:
        jax.random.uniform = orig
    assert not queue, "the JAX forward did not draw both noises"


def jleaves(tree):
    """A JAX params tree's leaves in the port's :func:`leaves` order."""
    return leaves(tm.map_params(lambda a: torch.from_numpy(
        np.asarray(a, np.float32)), jax.tree.map(np.asarray, tree)))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / den) if den else float(
        np.linalg.norm(a) > 0) * np.inf


def fixture_batch(fx):
    f = [fx[f"rays_{n}"] for n in Rays._fields]
    return f, fx["pixels"], fx["noise_sample"], fx["noise_resample"]


@functools.partial(jax.jit, static_argnums=0)
def _joint_step(jcfg, state, rays, pixels, sample, resample):
    """``joint_cadence_step`` compiled as the JAX package runs it, drawing
    the given noise."""
    with injected_noise(sample, resample):
        return jstep.joint_cadence_step(jcfg, state, rays, pixels)


def _unpack(state):
    moments = {k: [a.mu, a.nu] for k, a in state.opt_state.items()}
    counts = np.array([state.step, state.sched_count,
                       state.opt_state["prop"].count,
                       state.opt_state["nerf"].count])
    return state.params, moments, counts


def row_e(jcfg, state, rays, pixels, noise):
    """JAX's joint step: (aux, grads in the port's leaf order, updated
    proposal params) from ``state`` (a port state)."""
    jrays = JRays(*[jnp.asarray(x) for x in rays])
    zero = port_state(*_unpack(state), zero_moments=True)
    s1, aux = _joint_step(jcfg, jax_state(zero), jrays, jnp.asarray(pixels),
                          *noise)
    grads = [m / np.float32(1 - B1) for m in
             jleaves(s1.opt_state["prop"][0].mu)
             + jleaves(s1.opt_state["nerf"][0].mu)]
    s2, _ = _joint_step(jcfg, jax_state(state), jrays, jnp.asarray(pixels),
                        *noise)
    return ({k: float(v) for k, v in aux.items()}, grads,
            jleaves(s2.params["prop"]) + jleaves(s2.params["nerf"]))


def row_d(cfg, state, rays, pixels, noise):
    s = port_state(*_unpack(state))
    trays = Rays(*[torch.from_numpy(np.asarray(x)) for x in rays])
    tnoise = tm.RenderNoise(*[torch.from_numpy(np.asarray(x)) for x in noise])
    grads, aux = tstep.joint_cadence_grads(cfg, s, trays,
                                           torch.from_numpy(pixels),
                                           noise=tnoise)
    lr = tstep._lr(cfg.train, s.sched_count)
    for sub in ("prop", "nerf"):
        apply_updates_subtree(s.params[sub], grads[sub], s.opt_state[sub], lr,
                              cfg.train.weight_decay)
    return ({k: float(v) for k, v in aux.items()},
            [g.detach() for g in grads["prop"] + grads["nerf"]],
            _all_leaves(s.params))


def _all_leaves(params):
    return [p.detach().numpy().copy() for sub in ("prop", "nerf")
            for p in leaves(params[sub])]


def _update(p, before):
    return np.concatenate([np.ravel(np.asarray(b, np.float64)
                                    - np.asarray(a, np.float64))
                           for a, b in zip(p, before)])


def compare_rows(names, d, e, before):
    """Row e against row d: losses, per-leaf gradient rel L2, and the
    update (params ``before`` minus after) by rel L2 and its largest
    entry-wise difference."""
    (aux_d, g_d, p_d), (aux_e, g_e, p_e) = d, e
    rels = {n: rel_l2(ge, gd) for n, ge, gd in zip(names, g_e, g_d)}
    worst = max(rels, key=rels.get)
    return {"loss_prop": [aux_d["loss_prop"], aux_e["loss_prop"]],
            "loss": [aux_d["loss"], aux_e["loss"]],
            "loss_prop_rel": abs(aux_e["loss_prop"] - aux_d["loss_prop"])
            / abs(aux_d["loss_prop"]),
            "loss_rel": abs(aux_e["loss"] - aux_d["loss"])
            / abs(aux_d["loss"]),
            "grad_rel_l2_max": rels[worst], "worst_leaf": worst,
            "grad_rel_l2": rels,
            "g_max": [max(float(np.abs(np.asarray(g)).max()) for g in g_d),
                      max(float(np.abs(np.asarray(g)).max()) for g in g_e)],
            "update_rel_l2": rel_l2(_update(p_e, before),
                                    _update(p_d, before)),
            "update_max": float(np.abs(_update(p_d, before)).max()),
            "param_max_diff": max(
                float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(p_e, p_d))}


def _batch(run, k):
    """Step k's whole batch of rays and pixels (the trainer's index
    stream)."""
    from mipnerf360_torch.data import get_dataset
    from mipnerf360_torch.tools.parity_psnr import (_ours_cfg,
                                                    export_blender_scene)

    with tempfile.TemporaryDirectory() as tmp:
        scene = export_blender_scene(os.path.join(tmp, "scene"), run["res"])
        ds = get_dataset(_ours_cfg(scene, run["horizon"], tmp).data, "train",
                         white_bkgd=True)
        idx = ds.index_stack(1, run["batch"], run["seed"], k - 1)[0]
        return ([np.asarray(x)[idx] for x in ds.rays],
                np.asarray(ds.pixels)[idx])


def _chunks(batch, noise, chunk):
    rays, pixels = batch
    for lo in range(0, len(pixels), chunk):
        sl = slice(lo, lo + chunk)
        yield ([x[sl] for x in rays], pixels[sl],
               (noise[0][sl], noise[1][sl]), (len(pixels[sl]) / len(pixels)))


def _combine(pieces, train_cfg):
    """The step's losses from the chunks' (squared error over the batch
    size, distortion and distillation each scaled to the chunk's share)."""
    mse = sum(p[0] for p in pieces)
    loss_nerf = 30.0 + 10.0 * np.log10(mse)
    dist, prop = sum(p[1] for p in pieces), sum(p[2] for p in pieces)
    return {"loss_nerf": loss_nerf, "loss_dist": dist, "loss_prop": prop,
            "loss": loss_nerf + train_cfg.dist_loss_weight * dist + prop,
            "mse": mse}


class JaxSide:
    """The JAX package's step over a batch in chunks (jit per ``mode``)."""

    def __init__(self, jcfg, batch_size):
        self.cfg, self.b = jcfg, batch_size
        t = jcfg.train

        def pieces(params, rays, pixels, sample, resample, share):
            with injected_noise(sample, resample):
                tpr, wpr, o = jstep._forward_both(
                    params, jcfg.model, JRays(*rays), jax.random.PRNGKey(0),
                    True)
            sse = jnp.sum((o["rgb"][..., :3] - pixels[..., :3]) ** 2)
            dist = jax_distortion(o["s_vals"], o["weights"],
                                  t.dist_loss_reduction)
            prop = jax_distillation(jax.lax.stop_gradient(o["t_vals"]),
                                    jax.lax.stop_gradient(o["weights"]),
                                    tpr, wpr)
            scale = share if t.dist_loss_reduction == "mean" else 1.0
            return sse / self.b, dist * scale, prop * share

        def objective(params, c, *args):
            sse, dist, prop = pieces(params, *args)
            return c * sse + t.dist_loss_weight * dist + prop

        self.pieces = jax.jit(pieces)
        self.grad = jax.jit(jax.grad(objective))

    def losses(self, params, batch, noise, chunk):
        out = []
        for r, px, nz, share in _chunks(batch, noise, chunk):
            sse, dist, prop = self.pieces(params, tuple(map(jnp.asarray, r)),
                                          jnp.asarray(px), *nz, share)
            out.append((float(sse), float(dist), float(prop)))
        return _combine(out, self.cfg.train)

    def grads(self, params, batch, noise, chunk, mse):
        c = np.float32(10.0 / (np.log(10.0) * mse))
        total = None
        for r, px, nz, share in _chunks(batch, noise, chunk):
            g = self.grad(params, c, tuple(map(jnp.asarray, r)),
                          jnp.asarray(px), *nz, share)
            g = jax.tree.map(lambda x: np.asarray(x, np.float64), g)
            total = g if total is None else jax.tree.map(np.add, total, g)
        return total


class PortSide:
    """The port's step over a batch in chunks, on the CPU."""

    def __init__(self, cfg, batch_size):
        self.cfg, self.b = cfg, batch_size

    def _pieces(self, params, r, px, nz, share):
        t = self.cfg.train
        tpr, wpr, o = tstep._forward_both(
            params, self.cfg.model, Rays(*map(torch.from_numpy, r)),
            tm.RenderNoise(*map(torch.from_numpy, nz)), None, True)
        sse = torch.sum((o["rgb"][..., :3] - torch.from_numpy(px)[..., :3])
                        ** 2)
        dist = distortion_loss(o["s_vals"], o["weights"],
                               t.dist_loss_reduction)
        prop = distillation_loss(o["t_vals"].detach(), o["weights"].detach(),
                                 tpr, wpr)
        scale = share if t.dist_loss_reduction == "mean" else 1.0
        return sse / self.b, dist * scale, prop * share

    def losses(self, params, batch, noise, chunk):
        out = []
        with torch.no_grad():
            for r, px, nz, share in _chunks(batch, noise, chunk):
                sse, dist, prop = self._pieces(params, r, px, nz, share)
                out.append((float(sse), float(dist), float(prop)))
        return _combine(out, self.cfg.train)

    def grads(self, params, batch, noise, chunk, mse):
        c = float(np.float32(10.0 / (np.log(10.0) * mse)))
        ps = leaves(params["prop"]) + leaves(params["nerf"])
        total = None
        for r, px, nz, share in _chunks(batch, noise, chunk):
            sse, dist, prop = self._pieces(params, r, px, nz, share)
            obj = c * sse + self.cfg.train.dist_loss_weight * dist + prop
            g = [x.double().numpy() for x in torch.autograd.grad(obj, ps)]
            total = g if total is None else [a + b for a, b in zip(total, g)]
        return total


def full_batch(k, run, noises, state, modes, chunk):
    """Step k over its whole batch in each package, the package's own update
    of both subtrees, and the losses of step k+1 from there."""
    batches = [_batch(run, k + i) for i in (0, 1)]
    names = leaf_names(state.params["prop"], "prop.") + leaf_names(
        state.params["nerf"], "nerf.")
    _, cfg = configs(run, "off")
    before = _all_leaves(state.params)
    # the port
    side = PortSide(cfg, run["batch"])
    s = port_state(*_unpack(state))
    at_k = side.losses(s.params, batches[0], noises[0], chunk)
    g_port = side.grads(s.params, batches[0], noises[0], chunk, at_k["mse"])
    lr = tstep._lr(cfg.train, s.sched_count)
    n_prop = len(leaves(s.params["prop"]))
    for sub, g in (("prop", g_port[:n_prop]), ("nerf", g_port[n_prop:])):
        apply_updates_subtree(s.params[sub], [torch.from_numpy(
            x.astype(np.float32)) for x in g], s.opt_state[sub], lr,
            cfg.train.weight_decay)
    p_port = _all_leaves(s.params)
    at_k1 = side.losses(s.params, batches[1], noises[1], chunk)
    out = {"port": {"k": at_k, "k1": at_k1,
                    "g_max": max(float(np.abs(g).max()) for g in g_port),
                    "update_max": float(np.abs(_update(p_port,
                                                       before)).max())}}
    print(f"full batch, port: loss_prop {at_k['loss_prop']} at {k}, "
          f"{at_k1['loss_prop']} at {k + 1}; loss_nerf {at_k['loss_nerf']}, "
          f"{at_k1['loss_nerf']}", flush=True)
    js = jax_state(state)
    opt = jstate.make_optimizer(cfg.train.weight_decay)
    for mode in modes:
        jcfg, _ = configs(run, mode)
        side = JaxSide(jcfg, run["batch"])
        with pallas_mode(mode):
            j_k = side.losses(js.params, batches[0], noises[0], chunk)
            gj = side.grads(js.params, batches[0], noises[0], chunk,
                            j_k["mse"])
            lr = jstep._lr(jcfg.train, js.sched_count)
            params = {sub: jstate.apply_updates_subtree(
                opt, js.params[sub],
                jax.tree.map(lambda g: jnp.asarray(g, jnp.float32), gj[sub]),
                js.opt_state[sub], lr)[0] for sub in ("prop", "nerf")}
            j_k1 = side.losses(params, batches[1], noises[1], chunk)
        p_jax = [np.asarray(p) for p in jleaves(params["prop"])
                 + jleaves(params["nerf"])]
        gl = [np.asarray(g) for g in jleaves(gj["prop"]) + jleaves(gj["nerf"])]
        rels = {n: rel_l2(a, b) for n, a, b in zip(names, gl, g_port)}
        worst = max(rels, key=rels.get)
        out[mode] = {"k": j_k, "k1": j_k1, "grad_rel_l2": rels,
                     "grad_rel_l2_max": rels[worst], "worst_leaf": worst,
                     "g_max": max(float(np.abs(g).max()) for g in gl),
                     "update_rel_l2": rel_l2(_update(p_jax, before),
                                             _update(p_port, before)),
                     "update_max": float(np.abs(_update(p_jax,
                                                        before)).max())}
        print(f"full batch, JAX use_pallas={mode}: loss_prop "
              f"{j_k['loss_prop']} at {k}, {j_k1['loss_prop']} at {k + 1} "
              f"(its own step); loss_nerf {j_k['loss_nerf']}, "
              f"{j_k1['loss_nerf']}; gradient rel L2 max {rels[worst]:.3g} "
              f"({worst}), update rel L2 {out[mode]['update_rel_l2']:.3g}",
              flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dir")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--compute-dtype", default="",
                    help="run both packages' MLPs in this dtype instead of "
                         "the run's (float32 takes bf16 rounding out of the "
                         "comparison)")
    args = ap.parse_args(argv)
    with open(os.path.join(args.dir, "replay.json")) as f:
        run = json.load(f)
    if args.compute_dtype:
        run["model"]["compute_dtype"] = args.compute_dtype
    model = ModelConfig(**run["model"])
    p = tm.init_model(model)
    names = leaf_names(p["prop"], "prop.") + leaf_names(p["nerf"], "nerf.")
    modes = ("on", "off")
    k, state, noises, whole = load_state(args.dir, model)
    report = {"seed": run["seed"], "k": k, "nerf_moments": whole,
              "compute_dtype": run["model"]["compute_dtype"]}
    fx = dict(np.load(os.path.join(args.dir, f"fixture_{k}.npz")))
    rays, pixels, ns, nr = fixture_batch(fx)
    report["fixture"] = {"rays": int(len(pixels))}
    t0 = time.time()
    _, cfg = configs(run, "off")
    d = row_d(cfg, state, rays, pixels, (ns, nr))
    report["fixture"]["d"] = {x: d[0][x] for x in ("loss", "loss_prop",
                                                    "loss_nerf")}
    before = _all_leaves(state.params)
    for mode in modes:
        jcfg, _ = configs(run, mode)
        with pallas_mode(mode):
            e = row_e(jcfg, state, rays, pixels, (ns, nr))
        cmp = compare_rows(names, d, e, before)
        report["fixture"][f"e_{mode}"] = cmp
        print(f"step {k}, fixture rays, use_pallas={mode}: " + json.dumps(
            {x: cmp[x] for x in ("loss_prop", "loss_rel", "grad_rel_l2_max",
                                 "worst_leaf", "update_rel_l2",
                                 "param_max_diff")}), flush=True)
    report["fixture"]["seconds"] = round(time.time() - t0, 1)
    if args.full:
        assert whole, "--full needs nerf_moments_<k>.npz (the whole state)"
        t0 = time.time()
        report["full"] = full_batch(k, run, noises, state, modes, args.chunk)
        report["full"]["seconds"] = round(time.time() - t0, 1)
    name = f"row_e_{args.compute_dtype}" if args.compute_dtype else "row_e"
    with open(os.path.join(args.dir, f"{name}.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    main()
