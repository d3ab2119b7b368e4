"""The render forward's share of the bf16 peak, in %: the MLP FLOPs of the
window's rays over the window's time and 989 TFLOP/s."""
from nerfbench.yardstick import BF16_FLOPS_PER_S, flops_per_ray


def read(summary):
    if summary["kind"] != "render":
        return None
    flops = flops_per_ray(summary["model"], train=False) * summary["window"]["rate"]
    return 100.0 * flops / BF16_FLOPS_PER_S
