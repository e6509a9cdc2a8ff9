"""K5, TSDF integration: one RGB-D frame fused into the volume in place.

The port's counterpart of the JAX package's compiled program
``attentive_dfprior_tpu/tsdf/fusion.py:integrate_frame`` (``jax.jit`` with
its three volume arrays donated, so XLA runs the update as one loop over the
volume, written in place); it holds no ``pl.pallas_call``. ``integrate``
launches the CUDA kernel (``csrc/tsdf_integrate.cu``) for CUDA tensors and
runs the plain version, ``integrate_frame_plain``, for CPU tensors. On the
card the two are bit-identical: the kernel keeps the plain version's order
of operations, each rounded as its tensor op rounds it.

The kernel allocates nothing: the plain version makes some thirty
full-volume temporaries (with int64 pixel indices), which at room0's 196 M
voxels peak near 20 GiB beside the 3.66 GiB volume.

``plain_on_cuda`` is for checks alone (``chip_smoke.py``): inside it a CUDA
tensor takes the plain version, so the kernel's result can be held against
it through the callers' own entry points. No path of the port enters it.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Iterator, Tuple

import numpy as np
import torch

from attentive_dfprior_tpu_torch.ops.cuda.build import CudaKernel, check_launch


def _bind(lib: ctypes.CDLL) -> None:
    lib.tsdf_integrate_launch.argtypes = [
        *([ctypes.c_void_p] * 8),
        *([ctypes.c_int] * 5),
        *([ctypes.c_float] * 4),
        ctypes.c_void_p,
    ]
    lib.tsdf_integrate_launch.restype = ctypes.c_int


KERNEL = CudaKernel("tsdf_integrate", "tsdf_integrate.cu", _bind)
MAX_XY = 65535  # the kernel's grid takes x and y from blockIdx.z / blockIdx.y

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
    """Check the CUDA inputs and launch K5."""
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
    if X > MAX_XY or Y > MAX_XY:
        raise ValueError(f"tsdf_integrate: volume {(X, Y, Z)} has X or Y above {MAX_XY}")
    # the plain version's scalars as PyTorch's CUDA ops take them: float32,
    # and the division by trunc as a product with its float32 reciprocal
    trunc = np.float32(trunc_margin)
    lib = KERNEL.lib()
    with torch.cuda.device(tsdf.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tsdf_integrate_launch(
            tsdf.data_ptr(), weight.data_ptr(), color.data_ptr(), depth_im.data_ptr(), color_im.data_ptr(),
            intr.data_ptr(), w2c.data_ptr(), vol_origin.data_ptr(), X, Y, Z, H, W,
            float(np.float32(voxel_size)), float(-trunc), float(np.float32(1.0) / trunc),
            float(np.float32(obs_weight)), stream,
        )
    check_launch(KERNEL, rc)
    return tsdf, weight, color
