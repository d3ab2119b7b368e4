"""K1 and K2's share of their roofline in the traced train segment of the
published network, in %: each launch's byte bound at the [rays, samples] of
its level (two proposal rounds of 64 samples, the NeRF level's 32:
``paper.composite_bound_s``) over the launches' device time."""
from nerfbench.paper import composite_bound_s
from nerfbench.yardstick import K1, K2, class_launches, class_seconds


def read(summary):
    t = class_seconds(summary["kernels"])
    n = class_launches(summary["kernels"])
    spent = t.get(K1, 0.0) + t.get(K2, 0.0)
    if summary["kind"] != "train" or spent <= 0:
        return None
    need = composite_bound_s(summary["segment"]["composite"], n.get(K1, 0),
                             n.get(K2, 0))
    return 100.0 * need / spent
