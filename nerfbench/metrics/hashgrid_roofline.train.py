"""H1 and H2's share of their roofline in the traced train segment, in %:
the bytes no implementation can avoid (``zip.grid_bytes``: each sampling
level's intervals, rays and uniforms read, features written and cotangent
read once, each table's gradient written once) at the HBM peak, over the
kernels' device time. A yardstick, not a target: the kernels are bound by
their random gathers and atomics."""
from nerfbench.zip import grid_bound_s, grid_seconds


def read(summary):
    steps = summary["segment"].get("steps")
    spent = grid_seconds(summary["kernels"])
    if summary["kind"] != "train" or not steps or spent <= 0 \
            or "grid" not in summary["segment"]:
        return None
    rays = summary["segment"]["rays"] // steps
    return 100.0 * steps * grid_bound_s(summary["model"], rays) / spent
