"""95th percentile of the train window's chunk times on the host clock
(chunk boundary to chunk boundary, each chunk ending in its one transfer),
in ms. A stall in staging or a host sync shows here before the rate."""
from nerfbench.yardstick import percentile


def read(summary):
    chunks = summary["window"].get("chunk_s")
    if summary["kind"] != "train" or not chunks:
        return None
    return percentile(chunks, 95) * 1e3
