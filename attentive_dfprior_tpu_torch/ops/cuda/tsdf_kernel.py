"""K5, TSDF integration: one RGB-D frame fused into the volume in place.

The port's counterpart of the JAX package's compiled program
``attentive_dfprior_tpu/tsdf/fusion.py:integrate_frame`` (``jax.jit`` with
its three volume arrays donated, so XLA runs the update as one loop over the
volume, written in place); it holds no ``pl.pallas_call``. ``integrate``
launches the CUDA kernel (``csrc/tsdf_integrate.cu``) for CUDA tensors and
runs the plain version, ``integrate_frame_plain``, for CPU tensors. On the
card the two are bit-identical: the kernel keeps the plain version's order
of operations, each rounded as its tensor op rounds it.

The kernel culls before it fuses: it projects only the voxels of each
(x, y) column's run, the z-range that can lie in front of the camera, in
the image and within the frame's largest depth plus the truncation, with a
slack that covers float32 rounding (the rule and its derivation are in the
source's header). ``kept_runs_plain`` states that rule in plain torch, with
the same double operations in the same order, for the tests and checks
(``tests/test_torch_tsdf_cull.py`` holds it conservative: every voxel the
plain version updates lies in its column's run); ``kept_runs`` gives the
kernel's own runs on the card. A call is three CUDA launches (the frame
packed as one float4 image with its depth maximum, the runs as a list of
items, the fusion over the list), counted as one launch of K5
(``LAUNCHES_PER_CALL``).

The kernel's scratch (the depth maxima, the packed frame, the list) is one
int32 buffer a (device, stream), made at the first call and grown only for
a volume or a frame that needs more, so later calls allocate nothing: the
plain version makes some thirty full-volume temporaries (with int64 pixel
indices), which at room0's 196 M voxels peak near 20 GiB beside the
3.66 GiB volume.

``plain_on_cuda`` is for checks alone (``chip_smoke.py``): inside it a CUDA
tensor takes the plain version, so the kernel's result can be held against
it through the callers' own entry points. No path of the port enters it.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from attentive_dfprior_tpu_torch.ops.cuda.build import CudaKernel, check_launch


def _bind(lib: ctypes.CDLL) -> None:
    lib.tsdf_integrate_launch.argtypes = [
        *([ctypes.c_void_p] * 9),
        *([ctypes.c_int] * 5),
        *([ctypes.c_float] * 4),
        ctypes.c_void_p,
    ]
    lib.tsdf_integrate_launch.restype = ctypes.c_int
    lib.tsdf_kept_runs_launch.argtypes = [
        *([ctypes.c_void_p] * 6),
        *([ctypes.c_int] * 5),
        *([ctypes.c_float] * 2),
        ctypes.c_void_p,
    ]
    lib.tsdf_kept_runs_launch.restype = ctypes.c_int
    lib.tsdf_scratch_words.argtypes = [ctypes.c_int] * 5
    lib.tsdf_scratch_words.restype = ctypes.c_longlong


KERNEL = CudaKernel("tsdf_integrate", "tsdf_integrate.cu", _bind)
MAX_XY = 65535  # X, Y and Z: a column x * Y + y fits 32 bits, z the item's 16
CHUNK = 128  # voxels of a column's run an item of the kernel's list covers at most
LAUNCHES_PER_CALL = 3  # CUDA launches of one call: the frame packed (and its depth maximum), the runs, the fusion
SLACK = 2.0**-20  # the rule's slack, relative (16 float32 unit roundoffs; csrc/tsdf_integrate.cu)

_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}
_SCRATCH_LOCK = threading.Lock()

_PLAIN = threading.local()


@contextlib.contextmanager
def plain_on_cuda() -> Iterator[None]:
    """Within the block (on this thread), CUDA tensors take the plain
    version too: the reference that checks hold K5 against."""
    prev = getattr(_PLAIN, "on", False)
    _PLAIN.on = True
    try:
        yield
    finally:
        _PLAIN.on = prev


@torch.no_grad()
def integrate_frame_plain(
    tsdf: torch.Tensor,
    weight: torch.Tensor,
    color: torch.Tensor,
    depth_im: torch.Tensor,
    color_im: torch.Tensor,
    intr: torch.Tensor,
    w2c: torch.Tensor,
    vol_origin: torch.Tensor,
    voxel_size: float,
    trunc_margin: float,
    obs_weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the update as one pass of tensor ops over the whole
    volume (the JAX function's body), written back in place."""
    X, Y, Z = tsdf.shape
    H, W = depth_im.shape
    dev, f32 = tsdf.device, tsdf.dtype
    vx = torch.arange(X, device=dev, dtype=torch.int32).view(X, 1, 1).expand(X, Y, Z)
    vy = torch.arange(Y, device=dev, dtype=torch.int32).view(1, Y, 1).expand(X, Y, Z)
    vz = torch.arange(Z, device=dev, dtype=torch.int32).view(1, 1, Z).expand(X, Y, Z)
    px = vol_origin[0] + vx.to(f32) * voxel_size
    py = vol_origin[1] + vy.to(f32) * voxel_size
    pz = vol_origin[2] + vz.to(f32) * voxel_size
    cx_ = w2c[0, 0] * px + w2c[0, 1] * py + w2c[0, 2] * pz + w2c[0, 3]
    cy_ = w2c[1, 0] * px + w2c[1, 1] * py + w2c[1, 2] * pz + w2c[1, 3]
    cz_ = w2c[2, 0] * px + w2c[2, 1] * py + w2c[2, 2] * pz + w2c[2, 3]
    del px, py, pz

    safe_z = torch.where(cz_ == 0, torch.full_like(cz_, 1e-8), cz_)
    u = torch.round(intr[0, 0] * (cx_ / safe_z) + intr[0, 2]).to(torch.int64)
    v = torch.round(intr[1, 1] * (cy_ / safe_z) + intr[1, 2]).to(torch.int64)
    in_frustum = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (cz_ > 0)
    lin = torch.clamp(v, 0, H - 1) * W + torch.clamp(u, 0, W - 1)
    del u, v
    depth_val = depth_im.reshape(-1)[lin]
    depth_val = torch.where(in_frustum, depth_val, torch.zeros_like(depth_val))

    depth_diff = depth_val - cz_
    valid = (depth_val > 0) & (depth_diff >= -trunc_margin)
    dist = torch.clamp(depth_diff / trunc_margin, max=1.0)

    w_old = weight
    w_new = torch.where(valid, w_old + obs_weight, w_old)
    denom = torch.where(valid, w_new, torch.ones_like(w_new))
    tsdf.copy_(torch.where(valid, (tsdf * w_old + obs_weight * dist) / denom, tsdf))
    col = color_im.reshape(-1, 3)[lin]
    color.copy_(
        torch.where(
            valid[..., None],
            torch.clamp(torch.round((color * w_old[..., None] + obs_weight * col) / denom[..., None]), max=255.0),
            color,
        )
    )
    weight.copy_(w_new)
    return tsdf, weight, color


def cull_rules(dims: Sequence[int], vol_origin: Sequence[float], voxel_size: float, w2c: Sequence[Sequence[float]],
               intr: Sequence[Sequence[float]], H: int, W: int, dmax: float, trunc_margin: float
               ) -> Tuple[str, List[Tuple[float, float, float, float, float]]]:
    """The cull's rules for one frame: ("cull", [(gx, gy, gz, k, m)]),
    ("all", []) where an input is not finite, or ("none", []) where no pixel
    has depth > 0 (``dmax``, the frame's largest depth > 0, is then 0). A
    voxel (x, y, z) the frame can update satisfies every rule, ``gx x + gy y
    + gz z + k >= 0`` (``m = -1 / gz``). Python floats are IEEE doubles, so
    these are the operations of the kernel's ``make_rules``, in its order;
    the float32 inputs are exact in them."""
    if not dmax > 0.0:
        return "none", []
    def f32(x):
        return float(np.float32(x))

    u, vs, T = SLACK, f32(voxel_size), f32(trunc_margin)
    o = [f32(x) for x in vol_origin]
    pm = [abs(o[j]) + float(dims[j] - 1) * abs(vs) for j in range(3)]
    A = [[f32(w2c[i][j]) for j in range(4)] for i in range(3)]
    G = [[A[i][j] * vs for j in range(3)] for i in range(3)]
    K = [((A[i][0] * o[0] + A[i][1] * o[1]) + A[i][2] * o[2]) + A[i][3] for i in range(3)]
    E = [u * (((abs(A[i][0]) * pm[0] + abs(A[i][1]) * pm[1]) + abs(A[i][2]) * pm[2]) + abs(A[i][3])) for i in range(3)]
    rules = [(G[2][0], G[2][1], G[2][2], K[2] + E[2])]  # in front
    if not math.isinf(dmax):  # within depth
        D = ((dmax + T) + T * u) + E[2]
        rules.append((-G[2][0], -G[2][1], -G[2][2], D - K[2]))
    for a, n in ((0, float(W)), (1, float(H))):  # in the image: u, then v
        f, c = f32(intr[a][a]), f32(intr[a][2])
        pad = 1.0 + u * ((n + abs(c)) + 1.0)
        lo = (-0.5 - c) - pad
        hi = ((n - 0.5) - c) + pad
        s = abs(f) * E[a] + abs(lo) * E[2]
        rules.append(tuple(f * G[a][j] - lo * G[2][j] for j in range(3)) + ((f * K[a] - lo * K[2]) + s,))
        s = abs(f) * E[a] + abs(hi) * E[2]
        rules.append(tuple(hi * G[2][j] - f * G[a][j] for j in range(3)) + ((hi * K[2] - f * K[a]) + s,))
    out = []
    for gx, gy, gz, k in rules:
        m = -(1.0 / gz) if gz != 0.0 else 0.0
        if not all(math.isfinite(x) for x in (gx, gy, gz, k, m)):
            return "all", []  # no bound holds: keep every voxel
        out.append((gx, gy, gz, k, m))
    return "cull", out


def frame_depth_max(depth_im: torch.Tensor) -> float:
    """The frame's largest depth > 0 (NaN and depth <= 0 ignored, +inf
    kept), 0 where there is none: the kernel's first launch."""
    if depth_im.numel() == 0:
        return 0.0
    return float(torch.where(depth_im > 0, depth_im, torch.zeros_like(depth_im)).max())


@torch.no_grad()
def kept_runs_plain(dims: Sequence[int], vol_origin: torch.Tensor, voxel_size: float, w2c: torch.Tensor,
                    intr: torch.Tensor, depth_im: torch.Tensor, trunc_margin: float) -> torch.Tensor:
    """The plain rule of K5's cull: (X, Y, 2) int32 on the CPU, each column's
    run (z0, z1) of voxels the frame may update, (0, -1) where none may.
    Bit for bit the runs the kernel computes (``kept_runs``): the same
    double operations in the same order. For tests and checks alone."""
    X, Y, Z = (int(d) for d in dims)
    H, W = depth_im.shape
    state, rules = cull_rules((X, Y, Z), vol_origin.tolist(), voxel_size, w2c.tolist(), intr.tolist(), H, W,
                              frame_depth_max(depth_im), trunc_margin)
    lo = torch.zeros((X, Y), dtype=torch.float64)
    hi = torch.full((X, Y), float(Z - 1), dtype=torch.float64)
    empty = torch.full((X, Y), state == "none")
    xs = torch.arange(X, dtype=torch.float64).view(X, 1)
    ys = torch.arange(Y, dtype=torch.float64).view(1, Y)
    for gx, gy, gz, k, m in rules:
        b = (gx * xs + gy * ys) + k
        if gz > 0.0:
            lo = torch.maximum(lo, torch.ceil(b * m) + -1.0)
        elif gz < 0.0:
            hi = torch.minimum(hi, torch.floor(b * m) + 1.0)
        else:
            empty |= b < 0.0
    empty |= lo > hi
    runs = torch.stack([lo, hi], dim=-1).to(torch.int32)
    runs[empty] = torch.tensor([0, -1], dtype=torch.int32)
    return runs


def kept_runs(depth_im: torch.Tensor, intr: torch.Tensor, w2c: torch.Tensor, vol_origin: torch.Tensor,
              dims: Sequence[int], voxel_size: float, trunc_margin: float) -> torch.Tensor:
    """The kernel's runs on the card: its first two launches alone, writing
    each column's run ((X, Y, 2) int32, as ``kept_runs_plain``). For checks
    alone: no launch of K5 is counted."""
    X, Y, Z = (int(d) for d in dims)
    H, W = depth_im.shape
    _check_dims(X, Y, Z)
    runs = torch.empty((X, Y, 2), dtype=torch.int32, device=depth_im.device)
    lib = KERNEL.lib()
    with torch.cuda.device(depth_im.device):
        stream = torch.cuda.current_stream().cuda_stream
        buf = _scratch(lib, depth_im.device, stream, X, Y, Z, H, W)
        rc = lib.tsdf_kept_runs_launch(
            depth_im.data_ptr(), intr.data_ptr(), w2c.data_ptr(), vol_origin.data_ptr(), buf.data_ptr(),
            runs.data_ptr(), X, Y, Z, H, W, float(np.float32(voxel_size)), float(np.float32(trunc_margin)), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{KERNEL.name}: CUDA launch failed with cudaError {rc}")
    return runs


def _check_dims(X: int, Y: int, Z: int) -> None:
    if max(X, Y, Z) > MAX_XY:
        raise ValueError(f"tsdf_integrate: volume {(X, Y, Z)} has a dimension above {MAX_XY}")
    if X * Y * -(-Z // CHUNK) >= 2**31:
        raise ValueError(f"tsdf_integrate: volume {(X, Y, Z)} needs 2^31 or more items")


def _scratch(lib: ctypes.CDLL, device: torch.device, stream: int, X: int, Y: int, Z: int, H: int,
             W: int) -> torch.Tensor:
    """The kernel's scratch for this (device, stream): made at the first
    call, grown only when a volume or a frame needs more (zeroed: the
    kernel zeroes its count at every call itself)."""
    words = lib.tsdf_scratch_words(X, Y, Z, H, W)
    key = (device.index, stream)
    with _SCRATCH_LOCK:
        buf = _SCRATCH.get(key)
        if buf is None or buf.numel() < words:
            buf = torch.zeros(words, dtype=torch.int32, device=device)
            _SCRATCH[key] = buf
    return buf


def integrate(
    tsdf: torch.Tensor,
    weight: torch.Tensor,
    color: torch.Tensor,
    depth_im: torch.Tensor,
    color_im: torch.Tensor,
    intr: torch.Tensor,
    w2c: torch.Tensor,
    vol_origin: torch.Tensor,
    voxel_size: float,
    trunc_margin: float,
    obs_weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fuse one frame in place (``tsdf/fusion.py:integrate_frame``'s
    arguments). A CPU tensor takes the plain version; a CUDA tensor
    launches K5 on the current stream (or raises)."""
    args = (tsdf, weight, color, depth_im, color_im, intr, w2c, vol_origin, voxel_size, trunc_margin, obs_weight)
    if tsdf.device.type == "cpu" or getattr(_PLAIN, "on", False):
        return integrate_frame_plain(*args)
    if tsdf.device.type != "cuda":
        raise ValueError(f"tsdf_integrate: unsupported device {tsdf.device}")
    return integrate_launch(*args)


def integrate_launch(tsdf, weight, color, depth_im, color_im, intr, w2c, vol_origin,
                     voxel_size: float, trunc_margin: float, obs_weight: float = 1.0):
    """Check the CUDA inputs and launch K5 (``LAUNCHES_PER_CALL`` CUDA
    launches, counted as one)."""
    X, Y, Z = tsdf.shape
    H, W = depth_im.shape
    want = {"tsdf": (tsdf, (X, Y, Z)), "weight": (weight, (X, Y, Z)), "color": (color, (X, Y, Z, 3)),
            "depth_im": (depth_im, (H, W)), "color_im": (color_im, (H, W, 3)), "intr": (intr, (3, 3)),
            "w2c": (w2c, (4, 4)), "vol_origin": (vol_origin, (3,))}
    for name, (t, shape) in want.items():
        if t.device != tsdf.device:
            raise ValueError(f"tsdf_integrate: {name} on {t.device}, tsdf on {tsdf.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"tsdf_integrate: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"tsdf_integrate: {name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"tsdf_integrate: {name} must be contiguous")
    _check_dims(X, Y, Z)
    # the plain version's scalars as PyTorch's CUDA ops take them: float32,
    # and the division by trunc as a product with its float32 reciprocal
    trunc = np.float32(trunc_margin)
    lib = KERNEL.lib()
    with torch.cuda.device(tsdf.device):
        stream = torch.cuda.current_stream().cuda_stream
        buf = _scratch(lib, tsdf.device, stream, X, Y, Z, H, W)
        rc = lib.tsdf_integrate_launch(
            tsdf.data_ptr(), weight.data_ptr(), color.data_ptr(), depth_im.data_ptr(), color_im.data_ptr(),
            intr.data_ptr(), w2c.data_ptr(), vol_origin.data_ptr(), buf.data_ptr(), X, Y, Z, H, W,
            float(np.float32(voxel_size)), float(trunc), float(np.float32(1.0) / trunc),
            float(np.float32(obs_weight)), stream,
        )
    check_launch(KERNEL, rc)
    return tsdf, weight, color
