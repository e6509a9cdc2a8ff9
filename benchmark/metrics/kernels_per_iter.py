"""Device kernels (copies and fills left out) in the traced cycle over its
mapping and tracking iterations."""

from benchmark.metrics._trace import kernel_count


def read(record):
    t = record.get("trace")
    if not t:
        return None
    return kernel_count(t["device"]) / (t["map_iters"] + t["track_iters"])
