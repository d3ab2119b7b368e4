"""The MLP GEMMs' share of their roofline in the traced train segment, in
%: the least time of the FLOPs the segment's rays need at the bf16 peak
over the device time of the kernels classed as GEMMs."""
from nerfbench.yardstick import BF16_FLOPS_PER_S, GEMM, class_seconds, flops_per_ray


def read(summary):
    t = class_seconds(summary["kernels"]).get(GEMM, 0.0)
    if summary["kind"] != "train" or t <= 0:
        return None
    need = flops_per_ray(summary["model"], train=True) * summary["segment"]["rays"]
    return 100.0 * need / BF16_FLOPS_PER_S / t
