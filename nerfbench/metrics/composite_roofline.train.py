"""K1 and K2's share of their roofline in the traced train segment, in %:
the byte bound of each launch at its [rays, samples] over the launches'
device time."""
from nerfbench.yardstick import K1, K2, class_launches, class_seconds, k1_bound_s, k2_bound_s


def read(summary):
    t = class_seconds(summary["kernels"])
    n = class_launches(summary["kernels"])
    spent = t.get(K1, 0.0) + t.get(K2, 0.0)
    if summary["kind"] != "train" or spent <= 0:
        return None
    shapes = summary["segment"]["composite"]
    need = (n.get(K1, 0) * k1_bound_s(*shapes["K1"])
            + n.get(K2, 0) * k2_bound_s(*shapes["K2"]))
    return 100.0 * need / spent
