"""Device time per train step of the hash-grid kernels H1 and H2 (each
sampling level's encode and its table's gradient), in ms, selected by
kernel name from the traced segment."""
from nerfbench.zip import grid_seconds


def read(summary):
    steps = summary["segment"].get("steps")
    spent = grid_seconds(summary["kernels"])
    if summary["kind"] != "train" or not steps or spent <= 0:
        return None
    return 1e3 * spent / steps
