"""Device kernels (copies and fills left out) in the traced refine over its
entries x the refine's iterations."""

from benchmark.metrics._trace import kernel_count


def read(record):
    t = record.get("trace")
    if not t:
        return None
    return kernel_count(t["device"]) / (t["frames"] * t["iters"])
