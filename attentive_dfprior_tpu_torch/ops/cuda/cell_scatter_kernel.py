"""K4, the ordered cell scatter: ``out[idx[i]] += rows[i]`` in a fixed order.

The port's own kernel; the TPU path has no Pallas kernel here. It replaces
the JAX package's XLA scatter-add of the cell scatter
(``attentive_dfprior_tpu/ops/grid_sample.py:322``), the first half of every
grid gradient (``ops/grid_sample.py:_cell_scatter``), whose order is fixed
on the TPU. An atomic ``index_add_`` on the card sums a cell's rows in the
order the threads arrive, so two runs of the port parted in the last bits
and then, the map's optimization being chaotic, in the first; this sum
depends on the inputs alone.

The order (``csrc/cell_scatter.cu``): the indices sorted stably, the
sorted positions cut into chunks of ``CHUNK``; each stretch of one index
inside one chunk (a segment) summed from zero in the points' order, then
each index's segments summed from zero in chunk order. An index whose rows
lie in one chunk gets the sequential sum of its rows. ``cell_scatter_sum``
launches the kernel for a CUDA tensor and runs ``cell_scatter_plain``, the
same association in PyTorch, for a CPU tensor; the two are bit-identical.
"""

from __future__ import annotations

import ctypes

import torch

from attentive_dfprior_tpu_torch.ops.cuda.build import CudaKernel, check_launch

CHUNK = 32  # sorted positions a chunk (csrc/cell_scatter.cu: one per lane of a warp)


def _bind(lib: ctypes.CDLL) -> None:
    lib.cell_scatter_chunk_size.argtypes = []
    lib.cell_scatter_chunk_size.restype = ctypes.c_int
    lib.cell_scatter_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.cell_scatter_launch.restype = ctypes.c_int
    if lib.cell_scatter_chunk_size() != CHUNK:
        raise RuntimeError(f"cell_scatter.cu's chunk is {lib.cell_scatter_chunk_size()}, the wrapper's {CHUNK}")


KERNEL = CudaKernel("cell_scatter", "cell_scatter.cu", _bind)


def sequential_sum(nrows: int, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``out[idx[i]] += rows[i]`` for i = 0, 1, ... one after another, from
    zeros: on the CPU ``index_add_``; on a CUDA tensor ``index_put_(...,
    accumulate=True)``, which sorts the indices stably and adds each run of
    equal indices in turn (the CPU's ``index_put_`` would add with atomics
    across threads)."""
    out = torch.zeros((nrows, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    if out.is_cuda:
        return out.index_put_((idx,), rows, accumulate=True)
    return out.index_add_(0, idx, rows)


def cell_scatter_plain(nrows: int, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The kernel's sum in PyTorch: each segment (one index inside one chunk
    of the stably sorted positions) summed in order, then each index's
    segments in order, both with ``sequential_sum``. The segment sums have
    one row per position (those past the last segment stay zero) and an
    extra output row takes them, so nothing waits on the host."""
    n, width = rows.shape
    out_rows = nrows + 1
    if n == 0:
        return torch.zeros((nrows, width), dtype=rows.dtype, device=rows.device)
    scell, order = torch.sort(idx, stable=True)
    pos = torch.arange(n, device=idx.device)
    start = torch.ones((n,), dtype=torch.bool, device=idx.device)
    start[1:] = (scell[1:] != scell[:-1]) | (pos[1:] % CHUNK == 0)
    seg = torch.cumsum(start, 0) - 1
    seg_sums = sequential_sum(n, seg, rows[order])
    seg_cell = torch.full((n,), nrows, dtype=idx.dtype, device=idx.device).scatter_(0, seg, scell)
    return sequential_sum(out_rows, seg_cell, seg_sums)[:nrows]


def cell_scatter_sum(nrows: int, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(n,) int64 indices in [0, nrows) and (n, W) float32 rows -> (nrows, W)
    sums in the fixed order above. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel on the current stream (or raises)."""
    if rows.device.type == "cpu":
        return cell_scatter_plain(nrows, idx, rows)
    if rows.device.type != "cuda":
        raise ValueError(f"cell_scatter_sum: unsupported device {rows.device}")
    if rows.dtype != torch.float32:
        raise TypeError(f"cell_scatter_sum: rows must be float32, got {rows.dtype}")
    if rows.dim() != 2 or idx.shape != rows.shape[:1] or idx.device != rows.device:
        raise ValueError(f"cell_scatter_sum: idx {tuple(idx.shape)} on {idx.device} does not index rows "
                         f"{tuple(rows.shape)} on {rows.device}")
    if not 0 < nrows < 2**31:
        raise ValueError(f"cell_scatter_sum: {nrows} rows do not fit the kernel's int32 indices")
    rows = rows.contiguous()
    n, width = rows.shape
    lib = KERNEL.lib()
    out = torch.zeros((nrows, width), dtype=torch.float32, device=rows.device)
    if n == 0:
        return out
    scell, order = torch.sort(idx.to(torch.int32), stable=True)
    nchunks = (n + CHUNK - 1) // CHUNK
    first = torch.empty((nchunks, width), dtype=torch.float32, device=rows.device)
    last = torch.empty_like(first)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cell_scatter_launch(scell.data_ptr(), order.data_ptr(), rows.data_ptr(), out.data_ptr(),
                                     first.data_ptr(), last.data_ptr(), n, width, stream)
    check_launch(KERNEL, rc)
    return out
