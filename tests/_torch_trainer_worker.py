"""Worker of tests/test_torch_multihost.py (not a pytest module); 2 ranks,
usage in ``_torch_ranks.py``; argument: the checkpoint directory.

Runs the real trainer (``train/trainer.py::train``) on a mesh of both
ranks: device-bank staging with the background stager, batch and image
evals, keep_best and periodic saves, then ``resume=True`` to more steps.
Records the final params of both runs, the restored checkpoint on rank 0,
and how many checkpoint and metrics writes each rank made. Then a third
run resumes to 12 steps with the ranks disagreeing about the checkpoint:
rank 0 on a copy of the directory, rank 1 on an empty one (hosts without
a shared filesystem), and records each rank's step and params.
"""
import shutil
import sys

from _torch_ranks import join, save

RANK, NPROC, OUT, ARGS = join(sys.argv)

from _torch_parallel_cases import trainer_config  # noqa: E402
from mipnerf360_torch.train import checkpoint, init_train_state  # noqa: E402
from mipnerf360_torch.train import trainer as tr  # noqa: E402
from mipnerf360_torch.train.state import leaves  # noqa: E402
from mipnerf360_torch.utils import logging as mlog  # noqa: E402

writes = {"ckpt": 0, "metrics": 0}
real_write, real_log = checkpoint._write, mlog.MetricsLogger.log


def counted_write(*args):
    writes["ckpt"] += 1
    return real_write(*args)


def counted_log(self, *args):
    writes["metrics"] += int(self.primary)
    return real_log(self, *args)


checkpoint._write = counted_write
mlog.MetricsLogger.log = counted_log

ckpt_dir = ARGS[0]
out = {}
for name, steps, resume in (("first", 6, False), ("resumed", 9, True)):
    state = tr.train(trainer_config(ckpt_dir, NPROC, steps), resume=resume,
                     device="cpu")
    out[f"{name}_step"] = state.step
    out.update({f"{name}_param_{i}": p for i, p in
                enumerate(leaves(state.params))})
if RANK == 0:
    cfg = trainer_config(ckpt_dir, NPROC)
    restored = checkpoint.restore_checkpoint(
        ckpt_dir, init_train_state(cfg.model, cfg.train, device="cpu"))
    out["restored_step"] = restored.step
    out.update({f"restored_param_{i}": p for i, p in
                enumerate(leaves(restored.params))})
out.update({f"{k}_writes": v for k, v in writes.items()})
lone_dir = f"{ckpt_dir}_lone{RANK}"
if RANK == 0:
    shutil.copytree(ckpt_dir, lone_dir)
state = tr.train(trainer_config(lone_dir, NPROC, 12), resume=True,
                 device="cpu")
out["lone_step"] = state.step
out.update({f"lone_param_{i}": p for i, p in enumerate(leaves(state.params))})
save(OUT, RANK, **out)
