"""K7, the trilinear lookup: the scene query's feature grids sampled at N points.

The forward of every feature-grid sampler (``ops/grid_sample.py``: each
grid-gradient variant's ``autograd.Function`` and the fused pair) goes
through ``trilinear_gather`` / ``trilinear_gather_pair``. On a CUDA tensor
they launch the kernel (``csrc/trilinear_gather.cu``): the floor cell, the 8
corner rows and the blends of ``ops/grid_sample.py:trilinear_sample`` in
registers, one (N, C) row written a point and grid, the pair's two grids in
one launch. On a CPU tensor they run ``trilinear_sample`` itself, which is
the kernel's plain version: on the card the two are bit for bit equal.

The kernel takes float32 grids (nx, ny, nz, C), C in ``CHANNELS``,
contiguous and 16-byte aligned, and contiguous (N, 3) float32 points on the
same card; the wrapper raises on anything else. The JAX package leaves this
lookup to XLA (no Pallas kernel).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from attentive_dfprior_tpu_torch.ops.cuda.build import CudaKernel, check_launch

CHANNELS = (8, 16, 32, 64)  # C a grid row (csrc/trilinear_gather.cu: trilinear_gather_takes)


def _bind(lib: ctypes.CDLL) -> None:
    lib.trilinear_gather_takes.argtypes = [ctypes.c_int]
    lib.trilinear_gather_takes.restype = ctypes.c_int
    lib.trilinear_gather_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.trilinear_gather_launch.restype = ctypes.c_int
    got = tuple(c for c in range(1, 129) if lib.trilinear_gather_takes(c))
    if got != CHANNELS:
        raise RuntimeError(f"trilinear_gather.cu takes C in {got}, the wrapper {CHANNELS}")


KERNEL = CudaKernel("trilinear_gather", "trilinear_gather.cu", _bind)


def _plain(grids: Sequence[torch.Tensor], p_norm: torch.Tensor) -> List[torch.Tensor]:
    from attentive_dfprior_tpu_torch.ops.grid_sample import trilinear_sample

    return [trilinear_sample(g, p_norm) for g in grids]


def _check(grids: Sequence[torch.Tensor], p_norm: torch.Tensor) -> None:
    """Raise on what the kernel does not take (the device aside)."""
    if p_norm.dtype != torch.float32 or p_norm.dim() != 2 or p_norm.shape[1] != 3 or not p_norm.is_contiguous():
        raise ValueError(f"trilinear_gather: points must be a contiguous (N, 3) float32 tensor, got {p_norm.dtype} "
                         f"{tuple(p_norm.shape)}")
    shape = tuple(grids[0].shape)
    for g in grids:
        if g.device != p_norm.device or g.dtype != torch.float32:
            raise ValueError(f"trilinear_gather: grids must be float32 on {p_norm.device}, got {g.dtype} on "
                             f"{g.device}")
        if g.dim() != 4 or tuple(g.shape) != shape or shape[3] not in CHANNELS:
            raise ValueError(f"trilinear_gather: grids must share one shape (nx, ny, nz, C), C in {CHANNELS}, got "
                             f"{[tuple(t.shape) for t in grids]}")
        if not g.is_contiguous() or g.data_ptr() % 16:
            raise ValueError("trilinear_gather: grids must be contiguous and 16-byte aligned")


def _launch(grids: Sequence[torch.Tensor], p_norm: torch.Tensor) -> List[torch.Tensor]:
    """K7 on the current stream over one grid or a pair of one shape."""
    if p_norm.device.type != "cuda":
        raise ValueError(f"trilinear_gather: unsupported device {p_norm.device}")
    _check(grids, p_norm)
    nx, ny, nz, C = grids[0].shape
    n = p_norm.shape[0]
    outs = [torch.empty((n, C), dtype=torch.float32, device=p_norm.device) for _ in grids]
    if n == 0:
        return outs
    ptrs = [g.data_ptr() for g in grids] + [None] * (2 - len(grids))
    out_ptrs = [o.data_ptr() for o in outs] + [None] * (2 - len(outs))
    lib = KERNEL.lib()
    with torch.cuda.device(p_norm.device):
        n_sm = torch.cuda.get_device_properties(p_norm.device).multi_processor_count
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.trilinear_gather_launch(p_norm.data_ptr(), n, ptrs[0], ptrs[1], out_ptrs[0], out_ptrs[1],
                                         nx, ny, nz, C, n_sm, stream)
    check_launch(KERNEL, rc)
    return outs


def trilinear_gather(grid: torch.Tensor, p_norm: torch.Tensor) -> torch.Tensor:
    """``trilinear_sample(grid, p_norm)``: (N, C) features of a channels-last
    grid at (N, 3) normalized points; K7 on the card, the plain function
    on the CPU. No gradient (the samplers' backward forms it)."""
    if p_norm.device.type == "cpu":
        return _plain([grid], p_norm)[0]
    return _launch([grid], p_norm)[0]


def trilinear_gather_pair(
    grid_a: torch.Tensor, grid_b: torch.Tensor, p_norm: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two grids of one shape at the same points: one launch of K7 on the
    card (one index computation, two outputs), the plain function twice on
    the CPU."""
    outs = _plain([grid_a, grid_b], p_norm) if p_norm.device.type == "cpu" else _launch([grid_a, grid_b], p_norm)
    return outs[0], outs[1]
