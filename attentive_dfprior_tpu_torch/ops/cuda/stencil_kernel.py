"""K3, the cell stencil: (nvox, 8C) cell-corner buffer -> (nx, ny, nz, C)
grid gradient.

The port of ``attentive_dfprior_tpu/ops/pallas/stencil_kernel.py``
(``cell_stencil_pallas``), the second half of the ``pallas`` grid-gradient
variant (``ops/grid_sample.py:trilinear_sample_psc``). ``cell_stencil``
launches the CUDA kernel (``csrc/cell_stencil.cu``) for a CUDA tensor and
runs ``cell_stencil_plain`` for a CPU tensor. Both sum the eight corners in
the TPU kernel's association (plane x, then plane x-1, then their sum), so
they are bit-identical to each other; they agree with K1 and with the
``cellstencil`` variant, which sum in other orders, only to float32
round-off.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from attentive_dfprior_tpu_torch.ops.cuda.build import CudaKernel, check_launch


def _bind(lib: ctypes.CDLL) -> None:
    lib.cell_stencil_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.cell_stencil_launch.restype = ctypes.c_int


KERNEL = CudaKernel("cell_stencil", "cell_stencil.cu", _bind)


def cell_stencil_plain(grid_shape: Tuple[int, int, int, int], cells: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch stencil in the TPU kernel's order (``_kernel``,
    stencil_kernel.py:57-83): for plane x and then plane x-1, the corners
    (dy, dz) = (0,0), (0,1), (1,0), (1,1) shifted by their offsets and added
    one after another; then the two planes' sums. Zeros outside the grid."""
    nx, ny, nz, C = grid_shape
    B = cells.reshape(nx, ny, nz, 8, C)

    def plane(dx: int) -> torch.Tensor:
        acc = None
        for dy in (0, 1):
            for dz in (0, 1):
                e = torch.zeros((nx, ny, nz, C), dtype=cells.dtype, device=cells.device)
                e[dx:, dy:, dz:] = B[: nx - dx, : ny - dy, : nz - dz, 4 * dx + 2 * dy + dz]
                acc = e if acc is None else acc + e
        return acc

    return plane(0) + plane(1)


def cell_stencil(cells: torch.Tensor, grid_shape: Tuple[int, int, int, int]) -> torch.Tensor:
    """(nx*ny*nz, 8C) cell buffer -> (nx, ny, nz, C) grid gradient.

    A CPU tensor takes the plain stencil; a CUDA tensor launches the kernel
    on the current stream (or raises).
    """
    nx, ny, nz, C = (int(v) for v in grid_shape)
    if cells.device.type == "cpu":
        return cell_stencil_plain((nx, ny, nz, C), cells)
    if cells.device.type != "cuda":
        raise ValueError(f"cell_stencil: unsupported device {cells.device}")
    if cells.dtype != torch.float32:
        raise TypeError(f"cell_stencil: cells must be float32, got {cells.dtype}")
    if tuple(cells.shape) != (nx * ny * nz, 8 * C):
        raise ValueError(f"cell_stencil: cells shape {tuple(cells.shape)} != {(nx * ny * nz, 8 * C)}")
    if not cells.is_contiguous():
        raise ValueError("cell_stencil: cells must be contiguous")
    return cell_stencil_launch(cells, (nx, ny, nz, C))


def cell_stencil_launch(cells: torch.Tensor, grid_shape: Tuple[int, int, int, int]) -> torch.Tensor:
    """Launch the kernel on checked CUDA inputs (``cell_stencil`` does the
    checks); (nx, ny, nz, C)."""
    nx, ny, nz, C = grid_shape
    lib = KERNEL.lib()
    out = torch.empty((nx, ny, nz, C), dtype=torch.float32, device=cells.device)
    with torch.cuda.device(cells.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cell_stencil_launch(cells.data_ptr(), out.data_ptr(), nx, ny, nz, C, stream)
    check_launch(KERNEL, rc)
    return out
