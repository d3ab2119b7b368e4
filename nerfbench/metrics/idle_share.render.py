"""The device's idle share of the traced render segment, in %: 1 minus the
union of the device's operation intervals over the segment's wall time."""


def read(summary):
    if summary["kind"] != "render" or summary["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["wall_s"])
