"""K1 (csrc/halo_fold.cu): its least time, each call's cells read and gradient
written once (nvox x 9C x 4 B at 3.35 TB/s), over its device time in the
traced cycle, in %. Silent when the cycle's K1 launches are not the
configuration's grid-gradient calls."""

from benchmark.metrics._kernels import HBM_BYTES_PER_S, K1_NAMES, k1_bytes
from benchmark.metrics._trace import kernel_time
from benchmark.metrics._work import grid_gradient_calls


def read(record):
    t = record.get("trace")
    if not t:
        return None
    calls = grid_gradient_calls(record["cfg"]) * t["cycles"]
    n, seconds = kernel_time(t["device"], K1_NAMES)
    if n != len(calls) or seconds <= 0:
        return None
    bound = sum(k1_bytes(nvox, width // 8) for _, width, nvox in calls) / HBM_BYTES_PER_S
    return 100.0 * bound / seconds
