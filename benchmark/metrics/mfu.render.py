"""Model FLOPs of the window's frames (every pixel's samples through the four
decoders) over the window's seconds x 495 TFLOP/s (TF32 dense, H100 SXM), in
%."""

from benchmark.generate import camera
from benchmark.metrics._kernels import TF32_FLOPS_PER_S
from benchmark.metrics._work import render_flops


def read(record):
    w, cam = record["window"], camera(record["cfg"])
    return 100.0 * render_flops(record["cfg"], cam["H"], cam["W"]) * w["frames"] / (w["seconds"] * TF32_FLOPS_PER_S)
