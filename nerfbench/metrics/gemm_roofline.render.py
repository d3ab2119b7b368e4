"""The MLP GEMMs' share of their roofline in the traced render segment, in
%: the least time of the forward FLOPs of the segment's rays (the padding
of a view's last chunk is waste, not work) at the bf16 peak over the device time of the GEMM kernels."""
from nerfbench.yardstick import BF16_FLOPS_PER_S, GEMM, class_seconds, flops_per_ray


def read(summary):
    t = class_seconds(summary["kernels"]).get(GEMM, 0.0)
    if summary["kind"] != "render" or t <= 0:
        return None
    need = flops_per_ray(summary["model"], train=False) * summary["segment"]["rays"]
    return 100.0 * need / BF16_FLOPS_PER_S / t
