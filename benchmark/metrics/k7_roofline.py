"""K7 (csrc/trilinear_gather.cu): its least time, each launch's points read
(N x 3 x 4 B) and features written (N x C x 4 B a grid) at 3.35 TB/s, over
its device time in the traced renders, in %. N is the chunk's points (its
rays x the samples a ray), as ``k2_roofline`` counts them; C and the grids a
launch (1, or 2 for the fused pair) are its template arguments,
``trilinear_gather_kernel<C, G>``. The grid is not counted: a chunk reads a
thin slab of it, from the L2. Silent where the trace has no K7 launch (a
port without the kernel) or a launch's name carries no shape."""

import re
from typing import Optional, Tuple

from benchmark.metrics._kernels import HBM_BYTES_PER_S, function_name
from benchmark.metrics._work import samples_per_ray

K7_NAME = "trilinear_gather_kernel"


def k7_shape(trace_name: str) -> Optional[Tuple[int, int]]:
    """(C, grids) from ``trilinear_gather_kernel<C, G>``."""
    m = re.search(r"trilinear_gather_kernel<\s*(\d+)\s*,\s*(\d+)\s*>", trace_name)
    return (int(m.group(1)), int(m.group(2))) if m else None


def k7_bytes(n_points: int, c: int, grids: int) -> int:
    """The least bytes of one launch: the points read once, each grid's
    features written once."""
    return n_points * 3 * 4 + n_points * c * 4 * grids


def read(record):
    t = record.get("trace")
    if not t:
        return None
    points = t["chunk_rays"] * samples_per_ray(record["cfg"])
    bound = seconds = 0.0
    for name, _, d in t["device"]:
        if function_name(name) == K7_NAME:
            shape = k7_shape(name)
            if shape is None:
                return None
            bound += k7_bytes(points, *shape) / HBM_BYTES_PER_S
            seconds += d / 1e9
    return 100.0 * bound / seconds if seconds > 0 else None
