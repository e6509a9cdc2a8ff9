"""K2 (csrc/decoder_mlp.cu): its least time, the larger of the MLP's FLOPs at
the 495 TFLOP/s TF32 peak and its points, features, outputs and weights at
3.35 TB/s, for each launch at its own template shape over the padded chunk's
points, over its device time in the traced renders, in %."""

from benchmark.metrics._kernels import K2_NAME, function_name, k2_bound_s, k2_shape
from benchmark.metrics._work import samples_per_ray


def read(record):
    t = record.get("trace")
    if not t:
        return None
    points = t["chunk_rays"] * samples_per_ray(record["cfg"])
    bound = seconds = 0.0
    for name, _, d in t["device"]:
        if function_name(name) == K2_NAME:
            shape = k2_shape(name)
            if shape is None:
                return None
            bound += k2_bound_s(points, *shape)
            seconds += d / 1e9
    return 100.0 * bound / seconds if seconds > 0 else None
