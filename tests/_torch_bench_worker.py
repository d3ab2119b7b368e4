"""Worker of tests/test_torch_bench.py's two-rank test (not a pytest
module); usage in ``_torch_ranks.py``.

In the gloo group each rank runs the bench's default line (recording what
it printed), then the bench's loops through ``bench.measure`` on the data
mesh over both ranks, compute-only and with bank staging, and writes the
losses of every call and the params they end with.
"""
import contextlib
import io
import sys

import torch

from _torch_ranks import join, save

RANK, NPROC, OUT, ARGS = join(sys.argv)

from _torch_bench_cases import TINY, bench_args  # noqa: E402
from mipnerf360_torch.tools import bench  # noqa: E402
from mipnerf360_torch.train.state import leaves  # noqa: E402

printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    bench.run(bench_args(), TINY)
out = {"printed": len(printed.getvalue())}
with bench.placement("cpu") as (device, mesh):
    for name, staging in (("compute", False), ("bank", True)):
        cfg = bench.bench_config(bench_args(), TINY, True, mesh.data)
        m = bench.measure(bench_args(), cfg, staging, device, mesh)
        out[f"{name}_losses"] = torch.stack(m.losses)
        out[f"{name}_params"] = torch.cat(
            [p.detach().flatten() for p in leaves(m.state.params)])
save(OUT, RANK, **out)
