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

The kernel sorts by hand: an LSD radix sort over the key range alone
(``sort_plan``: ceil(log2(nrows)) bits in passes of at most ``RADIX_BITS``),
each pass stable through block-local ranks and a look-back over the tiles
before, five launches a call where the key fits 20 bits (two passes). ``emulate_sort`` runs that algorithm step by step in PyTorch, for
the tests; ``cell_sort`` runs the kernel's sort alone on the card.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from attentive_dfprior_tpu_torch.ops.cuda.build import CudaKernel, check_launch

CHUNK = 32  # sorted positions a chunk (csrc/cell_scatter.cu: one per lane of a warp)
RADIX_BITS = 10  # the most bits one pass sorts (1,024 digits)
TILE_KEYS = 2048  # keys a block of a pass ranks: 8 warps ...
WARP_KEYS = 256  # ... of 256 consecutive keys, ranked 32 at a time
MAX_KEYS = 2**30  # a look-back word counts below 2^30


def _bind(lib: ctypes.CDLL) -> None:
    for name in ("cell_scatter_chunk_size", "cell_scatter_tile_keys", "cell_scatter_warp_keys",
                 "cell_scatter_radix_bits"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.cell_scatter_workspace_words.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
    lib.cell_scatter_workspace_words.restype = ctypes.c_longlong
    lib.cell_scatter_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.cell_scatter_launch.restype = ctypes.c_int
    got = (lib.cell_scatter_chunk_size(), lib.cell_scatter_tile_keys(), lib.cell_scatter_warp_keys(),
           lib.cell_scatter_radix_bits())
    if got != (CHUNK, TILE_KEYS, WARP_KEYS, RADIX_BITS):
        raise RuntimeError(f"cell_scatter.cu's chunk, tile, warp keys and radix bits are {got}, the wrapper's "
                           f"{(CHUNK, TILE_KEYS, WARP_KEYS, RADIX_BITS)}")


KERNEL = CudaKernel("cell_scatter", "cell_scatter.cu", _bind)


def sort_plan(nrows: int) -> List[Tuple[int, int]]:
    """The radix passes that sort keys in [0, nrows): [(shift, bits)], the
    ceil(log2(nrows)) bits cut into the fewest passes of at most
    ``RADIX_BITS``, but two at least (the kernel's zero fill runs beside
    the last pass, after the first has marked the taken rows), as even as
    they go, the low bits first: 182,336 rows (room0's high grid) take 9 +
    9 bits, 312,984 (ScanNet's) 10 + 9; a pass of 0 bits keeps the order."""
    bits = (int(nrows) - 1).bit_length()
    passes = max(2, -(-bits // RADIX_BITS))
    base, extra = divmod(bits, passes)
    plan, shift = [], 0
    for p in range(passes):
        width = base + (1 if p < extra else 0)
        plan.append((shift, width))
        shift += width
    return plan


def emulate_sort(nrows: int, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's sort, step by step on the CPU: (sorted keys, their
    positions in ``idx``). Each pass of ``sort_plan`` cuts the keys into
    tiles of ``TILE_KEYS``, a tile into 8 warps of ``WARP_KEYS`` consecutive
    keys, a warp's keys into 32-key steps in order. A key's slot is its
    digit's start (the digit totals exclusive-scanned), plus the digit's
    count in the earlier tiles (the look-back), in the tile's earlier warps,
    in the warp's earlier steps (a counter per warp and digit), and among
    the lanes below it in its step with the same digit (one ballot a bit,
    then popc). Raises if the slots are not a permutation."""
    keys = idx.to(torch.int64).cpu()
    n = len(keys)
    vals = torch.arange(n)
    ntiles = -(-n // TILE_KEYS)
    warps, items = TILE_KEYS // WARP_KEYS, WARP_KEYS // 32
    pos = torch.arange(n)
    tile, warp = pos // TILE_KEYS, pos % TILE_KEYS // WARP_KEYS
    below = torch.tril(torch.ones((32, 32), dtype=torch.bool), -1)  # [lane, other]: other < lane
    radix = 1 << RADIX_BITS
    for shift, bits in sort_plan(nrows):
        d = (keys >> shift) & ((1 << bits) - 1)
        hist = torch.bincount(tile * radix + d, minlength=ntiles * radix).view(ntiles, radix)
        total = hist.sum(0)
        start = torch.cumsum(total, 0) - total
        steps = torch.full((ntiles * TILE_KEYS,), radix, dtype=torch.int64)  # lanes past n: the sentinel digit
        steps[:n] = d
        steps = steps.view(ntiles, warps, items, 32)
        count = torch.zeros((ntiles, warps, radix + 1), dtype=torch.int64)
        rank = torch.empty_like(steps)
        for j in range(items):
            dj = steps[:, :, j, :]
            peers = dj[..., :, None] == dj[..., None, :]
            rank[:, :, j, :] = count.gather(2, dj) + (peers & below).sum(-1)
            count.scatter_add_(2, dj, torch.ones_like(dj))
        count = count[..., :radix]
        tile_count = count.sum(1)
        if not torch.equal(tile_count, hist):
            raise AssertionError("the warps' counts do not add up to the tiles' histograms")
        warp_before = torch.cumsum(count, 1) - count
        tile_before = torch.cumsum(tile_count, 0) - tile_count
        slot = start[d] + tile_before[tile, d] + warp_before[tile, warp, d] + rank.reshape(-1)[:n]
        if not torch.equal(torch.sort(slot).values, pos):
            raise AssertionError("the slots of a pass are not a permutation")
        new_keys, new_vals = torch.empty_like(keys), torch.empty_like(vals)
        new_keys[slot], new_vals[slot] = keys, vals
        keys, vals = new_keys, new_vals
    return keys, vals


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


def _check(name: str, nrows: int, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """The CUDA entry points' checks (no device read)."""
    if idx.dtype != torch.int64:
        raise TypeError(f"{name}: idx must be int64, got {idx.dtype}")
    if rows.dim() != 2 or idx.dim() != 1 or idx.shape != rows.shape[:1] or idx.device != rows.device:
        raise ValueError(f"{name}: idx {tuple(idx.shape)} on {idx.device} does not index rows "
                         f"{tuple(rows.shape)} on {rows.device}")
    if not 0 < nrows < 2**31:
        raise ValueError(f"{name}: {nrows} rows do not fit the kernel's int32 indices")
    if len(idx) >= MAX_KEYS:
        raise ValueError(f"{name}: {len(idx)} indices, the kernel sorts fewer than {MAX_KEYS}")


def _launch(nrows: int, idx: torch.Tensor, rows: torch.Tensor, out, sort_only: bool) -> torch.Tensor:
    """One call of ``cell_scatter_launch`` on the current stream; returns
    the int32 workspace, whose first 2n words hold scell, then spos."""
    lib = KERNEL.lib()
    n, width = rows.shape
    plan = sort_plan(nrows)
    flat = (ctypes.c_int * (2 * len(plan)))(*[v for pair in plan for v in pair])
    ws = torch.empty((lib.cell_scatter_workspace_words(n, nrows, len(plan)),), dtype=torch.int32,
                     device=rows.device)
    nchunks = -(-n // CHUNK)
    fl = torch.empty((0 if sort_only else 2 * nchunks, width), dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.cell_scatter_launch(idx.data_ptr(), rows.data_ptr(), 0 if out is None else out.data_ptr(),
                                     ws.data_ptr(), fl.data_ptr(), n, nrows, width, len(plan), flat,
                                     int(sort_only), stream)
    check_launch(KERNEL, rc)
    return ws


def cell_scatter_sum(nrows: int, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(n,) int64 indices and (n, W) float32 rows -> (nrows, W) sums in the
    fixed order above. Every index must lie in [0, nrows): on the CPU the
    wrapper raises ``IndexError`` otherwise; on the card the kernel traps
    (a device-side fault, with no host read, so the call can be captured
    into a graph). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel on the current stream (or raises)."""
    if rows.device.type == "cpu":
        if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= nrows):
            raise IndexError(f"cell_scatter_sum: an index outside [0, {nrows}) "
                             f"(min {int(idx.min())}, max {int(idx.max())})")
        return cell_scatter_plain(nrows, idx, rows)
    if rows.device.type != "cuda":
        raise ValueError(f"cell_scatter_sum: unsupported device {rows.device}")
    if rows.dtype != torch.float32:
        raise TypeError(f"cell_scatter_sum: rows must be float32, got {rows.dtype}")
    _check("cell_scatter_sum", nrows, idx, rows)
    rows, idx = rows.contiguous(), idx.contiguous()
    out = torch.empty((nrows, rows.shape[1]), dtype=torch.float32, device=rows.device)
    if out.numel():
        _launch(nrows, idx, rows, out, sort_only=False)
    return out


def cell_sort(nrows: int, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's sort alone, on a CUDA tensor: (n,) int64 indices in [0,
    nrows) -> (sorted indices, their positions), both int32, the
    permutation ``torch.sort(idx, stable=True)`` gives."""
    if idx.device.type != "cuda":
        raise ValueError(f"cell_sort: the kernel's sort runs on a CUDA tensor, got {idx.device}")
    rows = torch.empty((len(idx), 0), dtype=torch.float32, device=idx.device)
    _check("cell_sort", nrows, idx, rows)
    n = len(idx)
    if n == 0:
        empty = torch.empty((0,), dtype=torch.int32, device=idx.device)
        return empty, empty
    ws = _launch(nrows, idx.contiguous(), rows, None, sort_only=True)
    return ws[:n], ws[n : 2 * n]
