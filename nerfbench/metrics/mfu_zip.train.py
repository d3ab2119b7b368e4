"""The whole train step's share of the bf16 peak for Zip-NeRF, in %: the
MLP FLOPs the window's rays need (``zip.flops_per_ray``: forward, dW, and
dX of the inputs that take a gradient, the grid features among them, on
both proposal rounds' and the NeRF level's samples) over the window's time
and 989 TFLOP/s."""
from nerfbench.yardstick import BF16_FLOPS_PER_S
from nerfbench.zip import flops_per_ray


def read(summary):
    if summary["kind"] != "train":
        return None
    flops = flops_per_ray(summary["model"], train=True) * summary["window"]["rate"]
    return 100.0 * flops / BF16_FLOPS_PER_S
