"""Worker of tests/test_torch_parallel.py's tensor-parallel tests (not a
pytest module); 2 or 4 ranks (``TP_MESHES``), usage in ``_torch_ranks.py``;
argument: the checkpoint directory.

From the trainer's initial state (broadcast from rank 0, then cut to this
rank's shard of the trunk) it takes the joint step's gradients (in float32
and in bfloat16) and one step
on its rows of the batch, gathers the full tree of each, renders through
the sharded trunk, scores one batch, and writes a checkpoint of the
gathered state (rank 0).
"""
import dataclasses
import sys

import torch

from _torch_ranks import join, save

RANK, NPROC, OUT, ARGS = join(sys.argv)

from _torch_parallel_cases import TP_MESHES, dp_batch, tp_config  # noqa: E402
from mipnerf360_torch.core.rays import dummy_rays  # noqa: E402
from mipnerf360_torch.models import mipnerf360 as tm  # noqa: E402
from mipnerf360_torch.parallel import make_mesh  # noqa: E402
from mipnerf360_torch.parallel.mesh import (broadcast_state_, gather_params,  # noqa: E402
                                            gather_state, shard_batch,
                                            shard_state)
from mipnerf360_torch.train import init_train_state  # noqa: E402
from mipnerf360_torch.train.checkpoint import save_checkpoint  # noqa: E402
from mipnerf360_torch.train import step as tstep  # noqa: E402
from mipnerf360_torch.train.state import leaves  # noqa: E402
from mipnerf360_torch.train.trainer import evaluate_batch  # noqa: E402


def tree_like(tree, flat):
    """``flat`` (in ``leaves`` order) arranged as ``tree``."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(tree)


data, model, depth = TP_MESHES[NPROC]
cfg = tp_config(depth)
mesh = make_mesh(data, model, device="cpu")
rays, pixels = shard_batch(mesh, *dp_batch())


def sharded_state():
    state = init_train_state(cfg.model, cfg.train, device="cpu")
    broadcast_state_(state)
    return shard_state(mesh, state)


out = {"data_index": mesh.data_index, "model_index": mesh.model_index}
state = sharded_state()
out.update({f"local_param_{i}": p for i, p in enumerate(leaves(state.params))})
grads, _ = tstep.joint_cadence_grads(cfg, state, rays, pixels, mesh=mesh)
full_grads = gather_params(mesh, {k: tree_like(state.params[k], grads[k])
                                  for k in ("prop", "nerf")})
out.update({f"grad_{i}": g for i, g in enumerate(
    leaves(full_grads["prop"]) + leaves(full_grads["nerf"]))})

bf16 = dataclasses.replace(cfg, model=dataclasses.replace(
    cfg.model, compute_dtype="bfloat16"))
grads, _ = tstep.joint_cadence_grads(bf16, sharded_state(), rays, pixels,
                                     mesh=mesh)
full_grads = gather_params(mesh, {k: tree_like(state.params[k], grads[k])
                                  for k in ("prop", "nerf")})
out.update({f"bf16_grad_{i}": g for i, g in enumerate(
    leaves(full_grads["prop"]) + leaves(full_grads["nerf"]))})

state, aux = tstep.make_train_step(cfg, mesh=mesh)(sharded_state(), rays,
                                                   pixels)
out.update({f"aux_{k}": v for k, v in aux.items()})
full = gather_state(mesh, state)
out.update({f"param_{i}": p for i, p in enumerate(leaves(full.params))})
out.update({f"mu_{i}": p for i, p in
            enumerate(leaves(full.opt_state["nerf"].mu))})
save_checkpoint(ARGS[0], full)

rgb, dist, acc = tm.render_image(state.params, cfg.model, dummy_rays(40),
                                 chunk=16, mesh=mesh, device="cpu")
out.update({"render_rgb": rgb, "render_distance": dist, "render_acc": acc})
out["eval_psnr"] = evaluate_batch(cfg, state.params, *dp_batch(), mesh=mesh)
save(OUT, RANK, **out)
