"""Worker of tests/test_torch_parallel.py's data-parallel tests (not a pytest
module); 2 or 4 ranks, usage in ``_torch_ranks.py``; argument: the
weight-bounds threshold of the "banded" case.

On a mesh of ``data=-1`` (the world) it runs one train step of each case of
``DP_CASES`` from the same initial state on its rows of the batch, drawing
the noise from the state's generator, and writes the aux losses, the
gradients (joint cadence) and the params after the step; it records which
weight-bounds form each case used, and the backward of the collectives on
one-element inputs.
"""
import sys

import torch

from _torch_ranks import join, save

RANK, NPROC, OUT, ARGS = join(sys.argv)

from mipnerf360_torch.losses import distillation as tdist  # noqa: E402
from mipnerf360_torch.parallel import make_mesh  # noqa: E402
from mipnerf360_torch.parallel.collectives import gather, global_sum  # noqa: E402
from mipnerf360_torch.parallel.mesh import shard_batch  # noqa: E402
from mipnerf360_torch.train import init_train_state  # noqa: E402
from mipnerf360_torch.train import step as tstep  # noqa: E402
from mipnerf360_torch.train.state import leaves  # noqa: E402
from _torch_parallel_cases import DP_CASES, dp_batch, dp_config  # noqa: E402

mesh = make_mesh(-1, 1, device="cpu")
out = {"mesh_data": mesh.data}
form = {}


def _spy(name):
    real = getattr(tdist, f"weight_bounds_{name}")

    def spy(*args):
        form["last"] = name
        return real(*args)
    setattr(tdist, f"weight_bounds_{name}", spy)


_spy("banded")
_spy("einsum")

for name, train in DP_CASES:
    tdist._BANDED_BYTES_THRESHOLD = (int(ARGS[0]) if name == "banded"
                                     else 2 * 1024**3)
    cfg = dp_config(**train)
    rays, pixels = shard_batch(mesh, *dp_batch())
    state = init_train_state(cfg.model, cfg.train, device="cpu")
    if cfg.train.cadence == "joint":
        probe = init_train_state(cfg.model, cfg.train, device="cpu")
        grads, _ = tstep.joint_cadence_grads(cfg, probe, rays, pixels,
                                             mesh=mesh)
        out.update({f"{name}_grad_{i}": g for i, g in
                    enumerate(grads["prop"] + grads["nerf"])})
    state, aux = tstep.make_train_step(cfg, mesh=mesh)(state, rays, pixels)
    out.update({f"{name}_aux_{k}": v for k, v in aux.items()})
    ps = leaves(state.params)
    out[f"{name}_n_params"] = len(ps)
    out.update({f"{name}_param_{i}": p for i, p in enumerate(ps)})
    out[f"{name}_form"] = form["last"]

# The collectives' backward on one-element inputs. global_sum: the loss is
# 3 times the sum. gather: rank j's loss is (j + 1) times the gathered sum.
x = torch.ones(1, requires_grad=True)
(out["global_sum_grad"],) = torch.autograd.grad(
    3.0 * global_sum(x, mesh.data_group).sum(), [x])
for key, sum_backward in (("gather_sum_grad", True), ("gather_own_grad", False)):
    (out[key],) = torch.autograd.grad(
        (RANK + 1.0) * gather(x, mesh.data_group, 0,
                              sum_backward=sum_backward).sum(), [x])
save(OUT, RANK, **out)
