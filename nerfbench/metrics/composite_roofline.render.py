"""K1's share of its roofline in the traced render segment, in %: the byte
bound of each launch at [chunk, samples] over the launches' device time."""
from nerfbench.yardstick import K1, class_launches, class_seconds, k1_bound_s


def read(summary):
    spent = class_seconds(summary["kernels"]).get(K1, 0.0)
    if summary["kind"] != "render" or spent <= 0:
        return None
    launches = class_launches(summary["kernels"])[K1]
    return 100.0 * launches * k1_bound_s(*summary["segment"]["composite"]["K1"]) / spent
