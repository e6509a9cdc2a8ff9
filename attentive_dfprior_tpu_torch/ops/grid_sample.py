"""Trilinear feature-grid sampling (align_corners=True, border padding).

The port of the JAX package's ``ops/grid_sample.py``. Grids are
channels-last ``(X, Y, Z, C)`` in natural axis order. A normalized
coordinate in [-1, 1] is unnormalized as (p+1)/2*(n-1), clamped to
[0, n-1] and blended between the 8 neighbours: z, then y, then x. On the
CPU the forward is bit-identical to the JAX package's ``trilinear_sample``.

Every sampler has the same forward, ``trilinear_sample``'s values: on the
card K7, the trilinear lookup (``ops/cuda/trilinear_kernel.py``), bit for
bit, one launch a grid and one for the fused pair; on the CPU
``trilinear_sample`` itself. They differ in how the grid gradient is
formed. ``sample_feature_grid(..., impl=)`` selects one by name (the JAX
package reads ``DFPRIOR_TRILINEAR_VJP`` instead):

  - ``halo`` (default): cell scatter + K1, the halo fold
    (``ops/cuda/halo_fold_kernel.py``);
  - ``bitfold``: cell scatter + the plain three-stage fold;
  - ``cellstencil``: cell scatter + corner-major transpose + 8 shifted
    slab adds;
  - ``pallas``: cell scatter + K3, the cell stencil
    (``ops/cuda/stencil_kernel.py``);
  - ``sorted``: the 8N corner updates sorted by voxel and reduced per
    run (cumulative sum), then written with unique indices;
  - ``xla``: plain autodiff of the gathers.

The cell scatter (``_cell_scatter``) writes each point's 8 weighted corner
updates into one 8C-wide row of its floor cell, the rows of a cell summed
in a fixed order (K4, ``ops/cuda/cell_scatter_kernel.py``: no atomics, so
a run repeats bit for bit). Each
custom gradient computes the point gradient (autodiff of the gathers, grid
detached) only when the points need one (the tracker, bundle adjustment),
and the grid gradient only when the grid needs one (the mapper). A kernel
wrapper runs the kernel on a CUDA tensor and its plain version on a CPU
tensor.

The JAX package falls back to ``cellstencil`` for an unknown name; here an
unknown name raises.

The TSDF prior is sampled by ``trilinear_sample_tsdf`` in the arithmetic
order of the JAX package's production rows sampler
(``trilinear_sample_rows``): a bilinear xy blend of the four corner columns
(r00, r01, r10, r11), then z. It does not depend on ``impl``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from attentive_dfprior_tpu_torch.ops.cuda.cell_scatter_kernel import cell_scatter_sum
from attentive_dfprior_tpu_torch.ops.cuda.halo_fold_kernel import cell_fold_halo, cell_fold_plain
from attentive_dfprior_tpu_torch.ops.cuda.stencil_kernel import cell_stencil
from attentive_dfprior_tpu_torch.ops.cuda.trilinear_kernel import trilinear_gather, trilinear_gather_pair
from attentive_dfprior_tpu_torch.utils.device import device_constant

GRID_VJPS = ("halo", "bitfold", "cellstencil", "xla", "sorted", "pallas")
# samplers whose high and color grids share one doubled-width scatter and fold
PAIR_VJPS = ("halo", "bitfold")


def normalize_3d_coordinate(p: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """World coordinates (..., 3) -> [-1, 1]^3 given a (3, 2) bound
    (ref: src/common.py:275-290)."""
    lo = bound[:, 0]
    hi = bound[:, 1]
    return (p - lo) / (hi - lo) * 2.0 - 1.0


def _floor_cell(dims_xyz: Tuple[int, int, int], p_norm: torch.Tensor):
    """Border-clamped unnormalized index: floor corner i0 (N, 3) int64,
    upper corner i1, fractional part f (N, 3)."""
    nx, ny, nz = dims_xyz
    dims = device_constant((float(nx), float(ny), float(nz)), p_norm.dtype, p_norm.device)
    idx = (p_norm + 1.0) * 0.5 * (dims - 1.0)
    # min/max (not clamp) so that a point exactly on the border splits the
    # gradient at the tie as the JAX reference's clip does
    idx = torch.minimum(torch.maximum(idx, torch.zeros_like(dims)), dims - 1.0)
    top = device_constant((nx - 1, ny - 1, nz - 1), torch.int64, p_norm.device)
    i0 = torch.minimum(torch.floor(idx).to(torch.int64), top)
    i1 = torch.minimum(i0 + 1, top)
    f = idx - i0.to(idx.dtype)
    return i0, i1, f


def trilinear_sample(grid: torch.Tensor, p_norm: torch.Tensor) -> torch.Tensor:
    """Sample a channels-last grid (NX, NY, NZ, C) at (N, 3) normalized
    coordinates (outside [-1, 1] clamps to the border); returns (N, C)."""
    nx, ny, nz, C = grid.shape
    i0, i1, f = _floor_cell((nx, ny, nz), p_norm)
    x0, y0, z0 = i0[:, 0], i0[:, 1], i0[:, 2]
    x1, y1, z1 = i1[:, 0], i1[:, 1], i1[:, 2]
    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    flat = grid.reshape(-1, C)

    def gather(ix, iy, iz):
        return flat.index_select(0, (ix * ny + iy) * nz + iz)

    c00 = gather(x0, y0, z0) * (1 - fz) + gather(x0, y0, z1) * fz
    c01 = gather(x0, y1, z0) * (1 - fz) + gather(x0, y1, z1) * fz
    c10 = gather(x1, y0, z0) * (1 - fz) + gather(x1, y0, z1) * fz
    c11 = gather(x1, y1, z0) * (1 - fz) + gather(x1, y1, z1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def _cell_updates(grid_shape, p_norm: torch.Tensor, ct: torch.Tensor):
    """Each point's floor cell i0 as a linear voxel id (N,) and its 8
    weighted corner updates (corner k = 4cx + 2cy + cz, the order of
    trilinear_sample) as one (N, 8C) row."""
    nx, ny, nz, C = grid_shape
    n_pts = p_norm.shape[0]
    i0, _, f = _floor_cell((nx, ny, nz), p_norm)
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    ws = []
    for wx in (1 - fx, fx):
        for wy in (1 - fy, fy):
            for wz in (1 - fz, fz):
                ws.append(wx * wy * wz)
    w = torch.stack(ws, dim=1)  # (N, 8)
    upd = (w[:, :, None] * ct[:, None, :]).reshape(n_pts, 8 * C)
    cell = (i0[:, 0] * ny + i0[:, 1]) * nz + i0[:, 2]
    return cell, upd


def _cell_scatter(grid_shape, p_norm: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Scatter each point's 8 weighted corner updates into one (8C)-wide
    row of the cell buffer, cell = floor corner i0, summed in a fixed order
    (K4, ``cell_scatter_sum``). Returns (nvox, 8C)."""
    nx, ny, nz, _ = grid_shape
    cell, upd = _cell_updates(grid_shape, p_norm, ct)
    return cell_scatter_sum(nx * ny * nz, cell, upd)


def _corner_indices_weights(grid_shape, p_norm: torch.Tensor):
    """Linear voxel ids (N, 8) and trilinear weights (N, 8) of each point's
    corners, corner k = 4cx + 2cy + cz."""
    nx, ny, nz = grid_shape[:3]
    i0, i1, f = _floor_cell((nx, ny, nz), p_norm)
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    ids, ws = [], []
    for cx, wx in ((i0[:, 0], 1 - fx), (i1[:, 0], fx)):
        for cy, wy in ((i0[:, 1], 1 - fy), (i1[:, 1], fy)):
            for cz, wz in ((i0[:, 2], 1 - fz), (i1[:, 2], fz)):
                ids.append((cx * ny + cy) * nz + cz)
                ws.append(wx * wy * wz)
    return torch.stack(ids, dim=1), torch.stack(ws, dim=1)


def _build_zpair(grid: torch.Tensor) -> torch.Tensor:
    """(NX, NY, NZ, C) grid -> (NX*NY*NZ, 2C) rows [grid[v], grid[v + 1 in
    z]]; the last z-plane repeats itself, which border clamping reads only
    with weight fz == 0."""
    nx, ny, nz, C = grid.shape
    shifted = torch.cat([grid[:, :, 1:], grid[:, :, nz - 1 :]], dim=2)
    return torch.cat([grid.reshape(-1, C), shifted.reshape(-1, C)], dim=1)


def trilinear_sample_zpair(grid: torch.Tensor, p_norm: torch.Tensor) -> torch.Tensor:
    """trilinear_sample through 4 z-pair row gathers; the same values (z mix
    per row first, then the same y and x blends). Plain autodiff."""
    nx, ny, nz, C = grid.shape
    i0, i1, f = _floor_cell((nx, ny, nz), p_norm)
    x0, y0, z0 = i0[:, 0], i0[:, 1], i0[:, 2]
    x1, y1 = i1[:, 0], i1[:, 1]
    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    dup = _build_zpair(grid)

    def zmix(ix, iy):
        r = dup.index_select(0, (ix * ny + iy) * nz + z0)
        return r[:, :C] * (1 - fz) + r[:, C:] * fz

    c0 = zmix(x0, y0) * (1 - fy) + zmix(x0, y1) * fy
    c1 = zmix(x1, y0) * (1 - fy) + zmix(x1, y1) * fy
    return c0 * (1 - fx) + c1 * fx


def _point_grad(grids, p_norm: torch.Tensor, cts) -> torch.Tensor:
    """Gradient w.r.t. the points: autodiff of the gathers, grids detached."""
    with torch.enable_grad():
        p = p_norm.detach().requires_grad_(True)
        outs = [trilinear_sample(g.detach(), p) for g in grids]
        (p_grad,) = torch.autograd.grad(outs, p, list(cts))
    return p_grad


# ---------------------------------------------------------------------------
# Grid gradients: (grid_shape, p_norm (N, 3), cotangent (N, C)) -> grid grad
# ---------------------------------------------------------------------------


def _halo_grid_grad(grid_shape, p_norm, ct):
    return cell_fold_halo(_cell_scatter(grid_shape, p_norm, ct), grid_shape)


def _bitfold_grid_grad(grid_shape, p_norm, ct):
    return cell_fold_plain(grid_shape, _cell_scatter(grid_shape, p_norm, ct))


def _pallas_grid_grad(grid_shape, p_norm, ct):
    return cell_stencil(_cell_scatter(grid_shape, p_norm, ct), grid_shape)


def _cell_stencil_grid_grad(grid_shape, p_norm, ct):
    """Cell scatter, one corner-major transpose, then the 8 corner slabs,
    each shifted by its corner offset with zeros in front, summed one after
    another (ref: ops/grid_sample.py:325-361)."""
    return _corner_slab_sum(grid_shape, _cell_scatter(grid_shape, p_norm, ct))


def _corner_slab_sum(grid_shape, cells: torch.Tensor) -> torch.Tensor:
    """The stencil half of ``_cell_stencil_grid_grad``: (nvox, 8C) cell
    rows -> the (nx, ny, nz, C) grid gradient."""
    nx, ny, nz, C = grid_shape
    corner_major = cells.reshape(nx * ny * nz, 8, C).transpose(0, 1).contiguous()
    out = None
    ci = 0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                y = corner_major[ci].reshape(nx, ny, nz, C)
                part = torch.zeros_like(y)
                part[dx:, dy:, dz:] = y[: nx - dx, : ny - dy, : nz - dz]
                out = part if out is None else out + part
                ci += 1
    return out


def _segmented_unique_scatter(ids: torch.Tensor, vals: torch.Tensor, nrows: int) -> torch.Tensor:
    """Sum rows with duplicate ids: sort by id, take each run's total as the
    difference of two cumulative sums, write the totals with unique ids
    (ref: ops/grid_sample.py:228-267). Returns (nrows, C)."""
    M, C = vals.shape
    out = torch.zeros((nrows, C), dtype=vals.dtype, device=vals.device)
    if M == 0:
        return out
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    csum = torch.cumsum(vals[order], dim=0)
    changed = sid[1:] != sid[:-1]
    edge = torch.ones((1,), dtype=torch.bool, device=ids.device)
    is_start = torch.cat([edge, changed])
    is_end = torch.cat([changed, edge])
    csum_prev = torch.cat([torch.zeros_like(csum[:1]), csum[:-1]])
    # each position's run start: the last start at or before it
    pos = torch.arange(M, device=ids.device)
    start = torch.cummax(torch.where(is_start, pos, torch.zeros_like(pos)), dim=0).values
    run_total = csum - csum_prev[start]
    out[sid[is_end]] = run_total[is_end]
    return out


def _sorted_grid_grad(grid_shape, p_norm, ct):
    nx, ny, nz, C = grid_shape
    ids, w = _corner_indices_weights(grid_shape, p_norm)
    vals = (w[..., None] * ct[:, None, :]).reshape(-1, C)
    return _segmented_unique_scatter(ids.reshape(-1), vals, nx * ny * nz).reshape(grid_shape)


def _vjp_sampler(grid_grad: Callable) -> type:
    """A ``torch.autograd.Function``: trilinear_sample's forward (K7 on the
    card), point gradient by autodiff of the gathers, grid gradient by
    ``grid_grad``."""

    class Sampler(torch.autograd.Function):
        @staticmethod
        def forward(ctx, grid, p_norm):
            ctx.save_for_backward(grid, p_norm)
            return trilinear_gather(grid, p_norm)

        @staticmethod
        def backward(ctx, g):
            grid, p_norm = ctx.saved_tensors
            grid_g = p_grad = None
            if ctx.needs_input_grad[1]:
                p_grad = _point_grad([grid], p_norm, [g])
            if ctx.needs_input_grad[0]:
                grid_g = grid_grad(tuple(grid.shape), p_norm, g.contiguous())
            return grid_g, p_grad

    return Sampler


_TrilinearHalo = _vjp_sampler(_halo_grid_grad)
_TrilinearBitfold = _vjp_sampler(_bitfold_grid_grad)
_TrilinearCellStencil = _vjp_sampler(_cell_stencil_grid_grad)
_TrilinearPallas = _vjp_sampler(_pallas_grid_grad)
_TrilinearSorted = _vjp_sampler(_sorted_grid_grad)


def trilinear_sample_halo(grid: torch.Tensor, p_norm: torch.Tensor) -> torch.Tensor:
    """Grid gradient: cell scatter + K1 (the production sampler,
    ref: ops/grid_sample.py:467-497)."""
    return _TrilinearHalo.apply(grid, p_norm)


def trilinear_sample_bf(grid: torch.Tensor, p_norm: torch.Tensor) -> torch.Tensor:
    """Grid gradient: cell scatter + the plain three-stage fold
    (ref: ops/grid_sample.py:434-464)."""
    return _TrilinearBitfold.apply(grid, p_norm)


def trilinear_sample_cs(grid: torch.Tensor, p_norm: torch.Tensor) -> torch.Tensor:
    """Grid gradient: cell scatter + transpose and 8 slab adds
    (ref: ops/grid_sample.py:403-426)."""
    return _TrilinearCellStencil.apply(grid, p_norm)


def trilinear_sample_psc(grid: torch.Tensor, p_norm: torch.Tensor) -> torch.Tensor:
    """Grid gradient: cell scatter + K3, the cell stencil
    (ref: ops/grid_sample.py:742-769)."""
    return _TrilinearPallas.apply(grid, p_norm)


def trilinear_sample_opt(grid: torch.Tensor, p_norm: torch.Tensor) -> torch.Tensor:
    """Grid gradient: sorted segmented reduction + unique-index write
    (ref: ops/grid_sample.py:701-728)."""
    return _TrilinearSorted.apply(grid, p_norm)


_SAMPLERS: Dict[str, Callable] = {
    "halo": trilinear_sample_halo,
    "bitfold": trilinear_sample_bf,
    "cellstencil": trilinear_sample_cs,
    "xla": trilinear_sample,
    "sorted": trilinear_sample_opt,
    "pallas": trilinear_sample_psc,
}


def grid_sampler(impl: str) -> Callable:
    """The sampler of grid-gradient variant ``impl`` (one of GRID_VJPS)."""
    if impl not in _SAMPLERS:
        raise ValueError(f"unknown grid-gradient impl {impl!r}; choose one of {GRID_VJPS}")
    return _SAMPLERS[impl]


class _TrilinearPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid_a, grid_b, p_norm, impl):
        ctx.save_for_backward(grid_a, grid_b, p_norm)
        ctx.impl = impl
        return trilinear_gather_pair(grid_a, grid_b, p_norm)

    @staticmethod
    def backward(ctx, g_a, g_b):
        grid_a, grid_b, p_norm = ctx.saved_tensors
        ga = gb = p_grad = None
        if ctx.needs_input_grad[2]:
            p_grad = _point_grad([grid_a, grid_b], p_norm, [g_a, g_b])
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            nx, ny, nz, C = grid_a.shape
            joint_shape = (nx, ny, nz, 2 * C)
            cells = _cell_scatter(joint_shape, p_norm, torch.cat([g_a, g_b], dim=1))
            if ctx.impl == "halo":
                joint = cell_fold_halo(cells, joint_shape)
            else:
                joint = cell_fold_plain(joint_shape, cells)
            ga = joint[..., :C] if ctx.needs_input_grad[0] else None
            gb = joint[..., C:] if ctx.needs_input_grad[1] else None
        return ga, gb, p_grad, None


def trilinear_sample_pair(
    grid_a: torch.Tensor, grid_b: torch.Tensor, p_norm: torch.Tensor, impl: str = "halo"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample two same-shape grids at the same points with one fused
    gradient: one (nvox, 16C) cell scatter and one 2C-wide fold, K1 for
    ``halo``, the plain fold for ``bitfold`` (ref: ops/grid_sample.py:518-580)."""
    if grid_a.shape != grid_b.shape:
        raise ValueError(f"pair grids differ: {tuple(grid_a.shape)} vs {tuple(grid_b.shape)}")
    if impl not in PAIR_VJPS:
        raise ValueError(f"the fused pair takes impl {PAIR_VJPS}, got {impl!r}")
    return _TrilinearPair.apply(grid_a, grid_b, p_norm, impl)


def sample_feature_grid(
    grid: torch.Tensor, p: torch.Tensor, bound: torch.Tensor, impl: str = "halo"
) -> torch.Tensor:
    """World points (N, 3) -> (N, C) grid features (ref: decoder.py:168-175),
    with the grid gradient of variant ``impl``."""
    return grid_sampler(impl)(grid, normalize_3d_coordinate(p, bound))


def sample_feature_grid_pair(
    grid_a: torch.Tensor, grid_b: torch.Tensor, p: torch.Tensor, bound: torch.Tensor, impl: str = "halo"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused pair sampling of two feature grids for the fold variants
    (``halo``, ``bitfold``); grids of different shapes and every other
    variant are sampled one by one (ref: ops/grid_sample.py:583-605)."""
    if grid_a.shape != grid_b.shape or impl not in PAIR_VJPS:
        return sample_feature_grid(grid_a, p, bound, impl), sample_feature_grid(grid_b, p, bound, impl)
    return trilinear_sample_pair(grid_a, grid_b, normalize_3d_coordinate(p, bound), impl)


def trilinear_sample_tsdf(vol: torch.Tensor, p_norm: torch.Tensor) -> torch.Tensor:
    """Sample a scalar (X, Y, Z) volume (border, align_corners=True) in the
    order of the JAX package's ``trilinear_sample_rows``: bilinear xy blend
    of the corner columns r00, r01, r10, r11, then the z blend. Gradients
    flow to the points only (the prior is constant). Returns (N,)."""
    nx, ny, nz = vol.shape
    i0, i1, f = _floor_cell((nx, ny, nz), p_norm)
    x0, y0, z0 = i0[:, 0], i0[:, 1], i0[:, 2]
    x1, y1, z1 = i1[:, 0], i1[:, 1], i1[:, 2]
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    flat = vol.reshape(-1)
    w00 = (1 - fx) * (1 - fy)
    w01 = (1 - fx) * fy
    w10 = fx * (1 - fy)
    w11 = fx * fy

    def blend(z):
        def at(ix, iy):
            return flat[(ix * ny + iy) * nz + z]

        return at(x0, y0) * w00 + at(x0, y1) * w01 + at(x1, y0) * w10 + at(x1, y1) * w11

    return blend(z0) * (1 - fz) + blend(z1) * fz
