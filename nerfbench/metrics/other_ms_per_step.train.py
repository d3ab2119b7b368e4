"""Device time per train step of the kernels that are neither GEMMs nor
K1/K2 (sampling, encode, losses, the MLP epilogue, AdamW, copies), in ms,
from the traced segment."""
from nerfbench.yardstick import OTHER, class_seconds


def read(summary):
    steps = summary["segment"].get("steps")
    if summary["kind"] != "train" or not steps:
        return None
    return 1e3 * class_seconds(summary["kernels"]).get(OTHER, 0.0) / steps
