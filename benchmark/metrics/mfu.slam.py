"""Model FLOPs of the window's cycles (benchmark/metrics/_work.py: forward of
the decoders each stage evaluates, activation backward where a gradient must
pass, weight gradients of decoders that train) over the window's seconds x
495 TFLOP/s (TF32 dense, H100 SXM), in %."""

from benchmark.metrics._kernels import TF32_FLOPS_PER_S
from benchmark.metrics._work import cycle_flops


def read(record):
    w = record["window"]
    flops = sum(cycle_flops(record["cfg"]).values()) * w["cycles"]
    return 100.0 * flops / (w["seconds"] * TF32_FLOPS_PER_S)
