"""95th percentile of the render window's view times on the host clock
(render_image and the copy of rgb, distance and acc to the host), in ms."""
from nerfbench.yardstick import percentile


def read(summary):
    views = summary["window"].get("view_s")
    if summary["kind"] != "render" or not views:
        return None
    return percentile(views, 95) * 1e3
