"""Model FLOPs of the window's refined entries over the window's seconds x
495 TFLOP/s (TF32 dense, H100 SXM), in %. A refine iteration is a tracking
iteration (benchmark/metrics/_work.py: every point through the forward of
all four decoders and one backward through them to the camera), the
loop closure's ``refine_iters`` of them an entry."""

from benchmark.metrics._kernels import TF32_FLOPS_PER_S
from benchmark.metrics._work import cycle_flops


def read(record):
    cfg, w = record["cfg"], record["window"]
    t, lc = cfg["tracking"], cfg["loop_closure"]
    per_iter = cycle_flops(cfg)["track"] / (int(cfg["mapping"]["every_frame"]) * int(t["iters"]))
    iters = int(lc["refine_iters"]) if lc.get("refine_iters") is not None else int(t["iters"])
    return 100.0 * per_iter * iters * w["frames"] / (w["seconds"] * TF32_FLOPS_PER_S)
