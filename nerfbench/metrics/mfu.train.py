"""The whole train step's share of the bf16 peak, in %: the MLP FLOPs the
window's rays need (forward, dW, and dX past the first layers) over the
window's time and 989 TFLOP/s."""
from nerfbench.yardstick import BF16_FLOPS_PER_S, flops_per_ray


def read(summary):
    if summary["kind"] != "train":
        return None
    flops = flops_per_ray(summary["model"], train=True) * summary["window"]["rate"]
    return 100.0 * flops / BF16_FLOPS_PER_S
