"""What each hand-written kernel's work needs, from its shapes: the bytes
it must move (each input read once, each output written once) and the
operations it must do, against the published peaks of one H100 SXM (NVIDIA's
data sheet, dense, 700 W): 3.35 TB/s of HBM3 and 495 TFLOP/s of TF32 on the
tensor cores, which no float32-accurate implementation can pass.

The kernels are named in a device trace by their CUDA function names:

  - K1 (``csrc/halo_fold.cu``): folds a grid's cell buffer (nvox, 8C) into
    its gradient (nvox, C);
  - K4 (``csrc/cell_scatter.cu``): the ordered scatter of N rows (N, W)
    with their cell indices into the (nvox, W) cell buffer;
  - K2 (``csrc/decoder_mlp.cu``): one decoder MLP over N points, its
    template arguments the feature width and the outputs.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12

K1_NAMES = ("halo_fold_kernel",)
K4_NAMES = ("hist_kernel", "pass_kernel", "sum_kernel", "run_join_kernel")
K2_NAME = "decoder_mlp_kernel"

EMBED, HIDDEN, BLOCKS, SKIP_IN = 93, 32, 5, 93


def function_name(trace_name: str) -> str:
    """The function's name in a kernel's trace name, with its namespaces:
    ``void (anonymous namespace)::pass_kernel<true>(...)`` -> ``pass_kernel``
    (an anonymous namespace dropped), ``void at::native::reduce_kernel<..>``
    -> ``at::native::reduce_kernel``."""
    s = trace_name
    mangled = re.match(r"_Z(\d+)", s)
    if mangled:  # a name the trace left mangled: _Z<length><name>...
        n = int(mangled.group(1))
        return s[mangled.end(): mangled.end() + n]
    if s.startswith("void "):
        s = s[5:]
    s = s.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", s, maxsplit=1)[0].strip()


def is_kernel(trace_name: str, names: Tuple[str, ...]) -> bool:
    """Whether a trace name is one of the hand-written kernels ``names``
    (top-level functions of the port's sources, in no named namespace)."""
    return function_name(trace_name) in names


def k1_bytes(nvox: int, c: int) -> int:
    """K1: the cell buffer (8C a voxel) read and the gradient (C) written."""
    return nvox * 9 * c * 4


def k4_bytes(n_rows: int, width: int, nvox: int) -> int:
    """K4: the rows and their int64 cell indices read once, the whole cell
    buffer written once."""
    return n_rows * width * 4 + n_rows * 8 + nvox * width * 4


def decoder_flops(c_dim: int, out: int) -> int:
    """One decoder's FLOPs a point (2 x multiply-adds): the Fourier
    projection (3 x 93), the five hidden blocks (93, 32, 32, 32 + 93, 32
    inputs to 32), the five feature linears (c_dim to 32) and the output."""
    macs = 3 * EMBED + HIDDEN * (EMBED + HIDDEN + HIDDEN + (HIDDEN + SKIP_IN) + HIDDEN)
    macs += BLOCKS * c_dim * HIDDEN + HIDDEN * out
    return 2 * macs


def decoder_weight_bytes(c_dim: int, out: int) -> int:
    floats = 3 * EMBED + (EMBED + 3 * HIDDEN + HIDDEN + SKIP_IN) * HIDDEN + BLOCKS * HIDDEN
    floats += BLOCKS * (c_dim * HIDDEN + HIDDEN) + HIDDEN * out + out
    return 4 * floats


def k2_bound_s(n_points: int, c_dim: int, out: int) -> float:
    """K2's least time: the larger of its FLOPs at the TF32 peak and its
    bytes (points and features in, outputs out, weights once) at HBM's."""
    flops = n_points * decoder_flops(c_dim, out)
    byts = n_points * (3 + c_dim + out) * 4 + decoder_weight_bytes(c_dim, out)
    return max(flops / TF32_FLOPS_PER_S, byts / HBM_BYTES_PER_S)


def k2_shape(trace_name: str) -> Optional[Tuple[int, int]]:
    """(feature width, outputs) from ``decoder_mlp_kernel<CD, OUT>``."""
    m = re.search(r"decoder_mlp_kernel<\s*(\d+)\s*,\s*(\d+)\s*>", trace_name)
    return (int(m.group(1)), int(m.group(2))) if m else None
