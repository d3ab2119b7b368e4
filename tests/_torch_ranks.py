"""Multi-rank harness of the port's parallel tests (not a pytest module).

The parent pytest process starts ``nproc`` ranks of a worker script
(``tests/_torch_*_worker.py``) as subprocesses; they rendezvous through a
``file://`` path under the test's ``tmp_path`` (no TCP port, so test files
running in parallel cannot collide) and form a gloo process group on the
CPU. Each rank writes its outputs to ``<out>/rank<r>.npz``; the parent
compares them with the JAX package and with the port's one-process result.
Workers import no JAX.

Worker command line: ``<worker> <rank> <nproc> <init_method> <out_dir>
[args...]``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
# Each rank's limit: a rank that waits on a collective its peers never
# reach ends the test at this limit instead of hanging the suite.
RANK_TIMEOUT_S = 300


def run_ranks(worker: str, nproc: int, tmp_path: Path, *args) -> list:
    """Run ``nproc`` ranks of ``tests/<worker>``; returns each rank's npz as
    a dict of arrays. Every rank gets its own ``communicate(timeout=...)``,
    and all of them are killed as soon as one fails."""
    out = tmp_path / "ranks_out"
    out.mkdir()
    path = [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(path))
    init = f"file://{tmp_path / 'rendezvous'}"
    # Each rank logs to a file, not a pipe: a rank blocked on a full pipe
    # would stall its peers' collectives.
    logs = [out / f"rank{r}.log" for r in range(nproc)]
    procs = []
    try:
        for r in range(nproc):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(REPO / "tests" / worker), str(r),
                     str(nproc), init, str(out), *map(str, args)],
                    cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        for r, p in enumerate(procs):
            p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, (f"rank {r} exited {p.returncode}:\n"
                                       f"{logs[r].read_text()}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(nproc)]


def join(argv):
    """In a worker: join the gloo group of ``argv`` (``sys.argv``) on the
    CPU; returns (rank, nproc, out_dir, the worker's own args)."""
    import torch

    from mipnerf360_torch.parallel import init_distributed

    torch.set_num_threads(1)
    rank, nproc = int(argv[1]), int(argv[2])
    init_distributed("cpu", init_method=argv[3], rank=rank, world_size=nproc)
    return rank, nproc, Path(argv[4]), argv[5:]


def save(out_dir: Path, rank: int, **arrays) -> None:
    """In a worker: write this rank's outputs (tensors or arrays) and leave
    the process group, once every rank is done with it."""
    import torch
    import torch.distributed as dist

    from mipnerf360_torch.parallel import shutdown

    np.savez(out_dir / f"rank{rank}.npz", **{
        k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
        for k, v in arrays.items()})
    dist.barrier()
    shutdown()
