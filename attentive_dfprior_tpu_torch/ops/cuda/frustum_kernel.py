"""K6, the frustum masks: one frame's gradient masks for every grid of a map.

The mapper masks each grid's gradient to the voxels the current frame can
see (``slam/mapper.py:get_frustum_mask``, numpy on the host, as in the JAX
package, which has no kernel for it). On the card ``Mapper.optimize_map``
computes the masks with this kernel (``csrc/frustum_mask.cu``) straight into
the static buffers its stage programs read, so the card no longer waits on
the host for them; on the CPU it keeps numpy.

``pack`` puts a call's host numbers in one float64 vector: numpy's inverse
of the pose, the intrinsics, the camera centre, the camera's width and
height, then each distinct lattice's start, step and stop per axis as
``np.linspace`` computes them (point ``i`` is ``i * step + start``, the last
point ``stop``). Grids of one shape share a lattice (room0's and ScanNet's
high and colour grids): it is computed once and written to each.

``frustum_masks_plain`` is the kernel's operation order in PyTorch float64
on the CPU, for the tests and ``chip_smoke.py`` alone; no path of the port
enters it. On the card the kernel equals it bit for bit; both equal
``get_frustum_mask`` voxel for voxel up to numpy's BLAS, which may round a
4x4 or 3x3 product differently in the last place (a mask moves only where a
value lies that close to a threshold).

A call is two CUDA launches (the frame sampled at every point with each
lattice's largest sample, then the tests and the writes), counted as one
launch of K6 (``LAUNCHES_PER_CALL``). The kernel's scratch (the partial
maxima) is one buffer a (device, stream), made at the first call.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from attentive_dfprior_tpu_torch.ops.cuda.build import CudaKernel, check_launch


def _bind(lib: ctypes.CDLL) -> None:
    lib.frustum_mask_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.frustum_mask_launch.restype = ctypes.c_int
    lib.frustum_partials_words.argtypes = []
    lib.frustum_partials_words.restype = ctypes.c_int


KERNEL = CudaKernel("frustum_mask", "frustum_mask.cu", _bind)
LAUNCHES_PER_CALL = 2  # CUDA launches of one call: the samples' maxima, the masks
MAX_LATTICES = 3  # distinct lattices a call (csrc/frustum_mask.cu: kMaxLattices)
MAX_OUTS = 3  # grid buffers a lattice (kMaxOuts)
HEAD = 30  # doubles before the lattices: w2c (16), K (9), the camera centre (3), W and H
DIST2 = 0.25  # squared metres: voxels this close to the camera centre are always kept

_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}
_SCRATCH_LOCK = threading.Lock()


class Packed(NamedTuple):
    """A call's host numbers: ``params`` (float64, ``HEAD`` + 9 a lattice),
    ``dims`` ((lattices, 3) int32) and ``groups``, for each lattice the
    indices of the grids that share it."""

    params: np.ndarray
    dims: np.ndarray
    groups: List[List[int]]


def linspace_params(start: float, stop: float, n: int) -> Tuple[float, float, float]:
    """(start, step, stop) of ``np.linspace(start, stop, n)``: its point
    ``i`` is ``i * step + start``, its last ``stop`` (one point: ``start``)."""
    step = (stop - start) / (n - 1) if n > 1 else 0.0
    return float(start), float(step), float(stop)


def pack(c2w: np.ndarray, shapes: Sequence[Sequence[int]], bound: np.ndarray, cam) -> Packed:
    """The host numbers of one call: the pose ``c2w`` (4, 4), the grids'
    ``shapes`` ((nx, ny, nz) each), the scene ``bound`` (3, 2) and the
    camera (``camera.Camera``)."""
    bound = np.asarray(bound, np.float64)
    c2w = np.asarray(c2w)
    w2c = np.linalg.inv(c2w.astype(np.float64))
    head = np.concatenate([w2c.reshape(-1), np.asarray(cam.K, np.float64).reshape(-1),
                           c2w[:3, 3].astype(np.float64), [float(cam.W), float(cam.H)]])
    distinct: List[Tuple[int, int, int]] = []
    groups: List[List[int]] = []
    for g, shape in enumerate(shapes):
        shape = tuple(int(s) for s in shape)
        if shape in distinct:
            groups[distinct.index(shape)].append(g)
        else:
            distinct.append(shape)
            groups.append([g])
    if len(distinct) > MAX_LATTICES or max(len(g) for g in groups) > MAX_OUTS:
        raise ValueError(f"frustum_mask: {len(distinct)} lattices for grids {list(shapes)} (at most {MAX_LATTICES} "
                         f"lattices of {MAX_OUTS} grids)")
    lattices = []
    for shape in distinct:
        axes = [linspace_params(bound[a, 0], bound[a, 1], shape[a]) for a in range(3)]
        lattices.append([p[i] for i in range(3) for p in axes])  # start x3, step x3, stop x3
    params = np.concatenate([head, np.asarray(lattices, np.float64).reshape(-1)])
    return Packed(params, np.asarray(distinct, np.int32).reshape(-1, 3), groups)


def lattice_axes(packed: Packed, lattice: int) -> List[torch.Tensor]:
    """The lattice's points per axis (float64 on the CPU), as the kernel
    computes them."""
    q = packed.params[HEAD + 9 * lattice: HEAD + 9 * lattice + 9]
    axes = []
    for a in range(3):
        n, start, step, stop = int(packed.dims[lattice, a]), float(q[a]), float(q[3 + a]), float(q[6 + a])
        t = torch.arange(n, dtype=torch.float64) * step + start
        if n > 1:
            t[-1] = stop
        axes.append(t)
    return axes


def _sample_plain(depth: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``mapper.py:_bilinear_sample_border0`` in torch: float32 pixels in,
    float32 samples out, the weights and sums in float64."""
    H, W = depth.shape
    u = torch.nan_to_num(u, nan=-1e9, posinf=1e9, neginf=-1e9).clamp(-2.0, W + 1.0)
    v = torch.nan_to_num(v, nan=-1e9, posinf=1e9, neginf=-1e9).clamp(-2.0, H + 1.0)
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u.double() - u0.double(), v.double() - v0.double()
    u0, v0 = u0.long(), v0.long()
    flat = depth.reshape(-1)
    out = torch.zeros(u.shape, dtype=torch.float64)
    for iu, iv, w in ((u0, v0, (1 - du) * (1 - dv)), (u0 + 1, v0, du * (1 - dv)), (u0, v0 + 1, (1 - du) * dv),
                      (u0 + 1, v0 + 1, du * dv)):
        valid = (iu >= 0) & (iu < W) & (iv >= 0) & (iv < H)
        val = torch.where(valid, flat[iv.clamp(0, H - 1) * W + iu.clamp(0, W - 1)], torch.zeros((), dtype=flat.dtype))
        out = out + w * val.double()
    return out.float()


@torch.no_grad()
def frustum_masks_plain(packed: Packed, depth: torch.Tensor) -> List[torch.Tensor]:
    """K6's operation order in PyTorch float64 on the CPU: one float32 {0, 1}
    mask (nx, ny, nz) a grid, in the order of ``pack``'s shapes (grids of
    one lattice get the same tensor). For tests and checks alone."""
    P = packed.params
    w, K, eye = P[:16].reshape(4, 4).tolist(), P[16:25].reshape(3, 3).tolist(), P[25:28].tolist()
    cam_w, cam_h = float(P[28]), float(P[29])
    depth = depth.detach().to("cpu", torch.float32).contiguous()
    n_grids = sum(len(g) for g in packed.groups)
    out: List[torch.Tensor] = [None] * n_grids  # type: ignore[list-item]
    for lat, group in enumerate(packed.groups):
        nx, ny, nz = (int(n) for n in packed.dims[lat])
        ax = lattice_axes(packed, lat)
        x = ax[0].view(nx, 1, 1).expand(nx, ny, nz).reshape(-1)
        y = ax[1].view(1, ny, 1).expand(nx, ny, nz).reshape(-1)
        z = ax[2].view(1, 1, nz).expand(nx, ny, nz).reshape(-1)
        c = [((w[r][0] * x + w[r][1] * y) + w[r][2] * z) + w[r][3] for r in range(3)]
        c[0] = -c[0]
        q = [(K[r][0] * c[0] + K[r][1] * c[1]) + K[r][2] * c[2] for r in range(3)]
        zz = q[2] + 1e-5
        u, v = (q[0] / zz).float(), (q[1] / zz).float()
        d = _sample_plain(depth, u, v)
        zero = d == 0
        if bool(zero.any()):
            d = torch.where(zero, d.max(), d)
        nz_ = -zz
        seen = (u < cam_w) & (u > 0) & (v < cam_h) & (v > 0) & (nz_ >= 0) & (nz_ <= (d + 0.5).double())
        near = ((x - eye[0]) * (x - eye[0]) + (y - eye[1]) * (y - eye[1])) + (z - eye[2]) * (z - eye[2]) < DIST2
        mask = (seen | near).float().reshape(nx, ny, nz)
        for g in group:
            out[g] = mask
    return out


def _scratch(lib: ctypes.CDLL, device: torch.device, stream: int) -> torch.Tensor:
    """The partial maxima for this (device, stream), made at the first call
    (every call writes them before it reads them)."""
    key = (device.index, stream)
    with _SCRATCH_LOCK:
        buf = _SCRATCH.get(key)
        if buf is None:
            buf = _SCRATCH[key] = torch.empty(lib.frustum_partials_words(), dtype=torch.int32, device=device)
    return buf


def frustum_masks(packed: Packed, depth: torch.Tensor, outs: Sequence[torch.Tensor]) -> None:
    """Launch K6 on the current stream: each grid's mask, float32 {0, 1},
    written into ``outs`` (one CUDA buffer a grid, in the order of
    ``pack``'s shapes, each of nx * ny * nz elements, contiguous) from
    ``depth`` ((H, W) float32 on the same card)."""
    if depth.device.type != "cuda":
        raise ValueError(f"frustum_mask: unsupported device {depth.device}")
    if depth.dtype != torch.float32 or depth.dim() != 2 or not depth.is_contiguous():
        raise ValueError(f"frustum_mask: depth must be a contiguous (H, W) float32 tensor, got {depth.dtype} "
                         f"{tuple(depth.shape)}")
    n_grids = sum(len(g) for g in packed.groups)
    if len(outs) != n_grids:
        raise ValueError(f"frustum_mask: {len(outs)} buffers for {n_grids} grids")
    ptrs = np.zeros((MAX_LATTICES, MAX_OUTS), np.uint64)
    for lat, group in enumerate(packed.groups):
        n = int(np.prod(packed.dims[lat]))
        for o, g in enumerate(group):
            t = outs[g]
            if t.device != depth.device or t.dtype != torch.float32 or t.numel() != n or not t.is_contiguous():
                raise ValueError(f"frustum_mask: grid {g}'s buffer must be {n} contiguous float32 on {depth.device}, "
                                 f"got {t.numel()} {t.dtype} on {t.device}")
            ptrs[lat, o] = t.data_ptr()
    params = np.ascontiguousarray(packed.params, np.float64)
    dims = np.ascontiguousarray(packed.dims, np.int32)
    H, W = depth.shape
    lib = KERNEL.lib()
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream().cuda_stream
        buf = _scratch(lib, depth.device, stream)
        rc = lib.frustum_mask_launch(params.ctypes.data, dims.ctypes.data, ptrs.ctypes.data, len(packed.groups),
                                     depth.data_ptr(), H, W, buf.data_ptr(), stream)
    check_launch(KERNEL, rc)
