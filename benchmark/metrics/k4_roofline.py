"""K4 (csrc/cell_scatter.cu): its least time, each call's rows and int64
indices read once and its whole cell buffer written once, at 3.35 TB/s, over
its device time (every launch of its kernels) in the traced cycle, in %.
Silent when the cycle's K1 launches (one a K4 call) are not the
configuration's grid-gradient calls."""

from benchmark.metrics._kernels import HBM_BYTES_PER_S, K1_NAMES, K4_NAMES, k4_bytes
from benchmark.metrics._trace import kernel_time
from benchmark.metrics._work import grid_gradient_calls


def read(record):
    t = record.get("trace")
    if not t:
        return None
    calls = grid_gradient_calls(record["cfg"]) * t["cycles"]
    n1, _ = kernel_time(t["device"], K1_NAMES)
    n, seconds = kernel_time(t["device"], K4_NAMES)
    if n1 != len(calls) or n == 0 or seconds <= 0:
        return None
    bound = sum(k4_bytes(rows, width, nvox) for rows, width, nvox in calls) / HBM_BYTES_PER_S
    return 100.0 * bound / seconds
