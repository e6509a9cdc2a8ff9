"""K5's plain version (``ops/cuda/tsdf_kernel.py:integrate_frame_plain``,
the TSDF fusion step) against the JAX package's ``tsdf/fusion.py:
integrate_frame`` on the CPU, and the wrapper's dispatch.

Each case fuses small frames made with numpy into a small volume through
both packages. Where a case's projections are exact (binary voxel size,
origin, pose and intrinsics) the two are held bit for bit; elsewhere at
``tests/test_torch_ops.py``'s tolerance: a voxel whose projection lands
within float32 roundoff of a pixel boundary may round to the neighbouring
pixel in one package, so at most 5e-3 of the voxels may differ. The kernel
itself runs on the card only (``chip_smoke.py`` phase 2 holds it
``torch.equal`` to this plain version there).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu.tsdf.fusion import integrate_frame as j_integrate
from attentive_dfprior_tpu_torch.ops.cuda import tsdf_kernel
from attentive_dfprior_tpu_torch.tsdf.fusion import TSDFVolume, integrate_frame

FRAC = 5e-3  # voxels that may round to a neighbouring pixel (tests/test_torch_ops.py:225)


def _frame(rng, H, W, fx, cx, cy, w2c, depth=(0.3, 2.5), zero_rows=0, ow=1.0, color_max=255.0):
    d = rng.uniform(*depth, (H, W)).astype(np.float32)
    d[:zero_rows] = 0.0
    c = np.minimum(rng.uniform(0.0, color_max * 1.2, (H, W, 3)), color_max).astype(np.float32)
    intr = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]], np.float32)
    return d, c, intr, np.asarray(w2c, np.float32), ow


def _pose(t, rot_deg=0.0):
    a = np.deg2rad(rot_deg)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    w2c[:3, 3] = t
    return w2c


def _fuse_both(dims, origin, voxel, frames):
    """Both packages from one fresh volume; returns (port, jax) as numpy
    (tsdf, weight, colour)."""
    jt, jw, jc = jnp.full(dims, -1.0), jnp.zeros(dims), jnp.zeros(dims + (3,))
    tt, tw, tc = torch.full(dims, -1.0), torch.zeros(dims), torch.zeros(dims + (3,))
    origin = np.asarray(origin, np.float32)
    for depth, color, intr, w2c, ow in frames:
        jt, jw, jc = j_integrate(jt, jw, jc, jnp.asarray(depth), jnp.asarray(color), jnp.asarray(intr),
                                 jnp.asarray(w2c), jnp.asarray(origin), voxel, 5 * voxel, ow)
        tsdf_kernel.integrate_frame_plain(tt, tw, tc, torch.tensor(depth), torch.tensor(color), torch.tensor(intr),
                                          torch.tensor(w2c), torch.tensor(origin), voxel, 5 * voxel, ow)
    return (tt.numpy(), tw.numpy(), tc.numpy()), tuple(np.asarray(a) for a in (jt, jw, jc))


def _camera_z(dims, origin, voxel, w2c):
    z = [origin[i] + np.arange(dims[i], dtype=np.float32) * np.float32(voxel) for i in range(3)]
    p = np.stack(np.meshgrid(*z, indexing="ij"), axis=-1)
    return p @ w2c[2, :3] + w2c[2, 3]


def _case(name):
    """(dims, origin, voxel, frames, exact) of a case."""
    rng = np.random.default_rng(CASES.index(name))
    # the cases held at the tolerance take generic intrinsics, poses and
    # voxels, so that few projections sit within roundoff of a pixel
    # boundary; half_boundaries and color_clamp put many exactly on one
    if name == "zero_depth_rows":
        frames = [_frame(rng, 18, 24, 20.3, 11.37, 8.61, _pose([0.113, -0.207, 1.19], 3.1), zero_rows=6)]
        return (24, 20, 22), (-1.0, -1.0, -0.5), 0.0813, frames, False
    if name == "behind_camera":  # the camera inside the volume, half of it behind
        frames = [_frame(rng, 16, 20, 10.3, 9.41, 7.37, _pose([0.053, 0.107, 0.0], 20.0))]
        return (20, 18, 24), (-0.8, -0.7, -1.0), 0.0813, frames, False
    if name == "camera_plane_roundoff":  # a z-plane at -0.3 + 3 * 0.1 = -1.5e-8 in float32, near cz = 0
        frames = [_frame(rng, 12, 16, 8.3, 7.41, 5.63, _pose([0.0, 0.0, 0.0]))]
        return (16, 14, 12), (-0.813, -0.707, -0.3), 0.1, frames, False
    if name == "half_boundaries":  # u = 4 x / z + 3.5, v likewise, x, y, z multiples of 1/8: exact
        frames = [_frame(rng, 8, 8, 4.0, 3.5, 3.5, _pose([0.0, 0.0, 0.0]), depth=(0.1, 2.0))]
        return (25, 17, 13), (-1.5, -1.0, -0.75), 0.125, frames, True
    if name == "obs_weight":
        frames = [_frame(rng, 18, 24, 20.3, 11.37, 8.61, _pose([0.113, -0.207, 1.19], 3.1), ow=0.5),
                  _frame(rng, 18, 24, 20.3, 11.37, 8.61, _pose([0.161, -0.193, 1.21], 5.3), ow=2.0)]
        return (24, 20, 22), (-1.0, -1.0, -0.5), 0.0813, frames, False
    if name.startswith("sequence_"):
        n = int(name.split("_")[1])
        frames = [_frame(rng, 18, 24, 20.3, 11.37, 8.61, _pose([0.113 + 0.051 * k, -0.207, 1.19], 3.1 + 4.0 * k))
                  for k in range(n)]
        return (24, 20, 22), (-1.0, -1.0, -0.5), 0.0813, frames, False
    if name == "color_clamp":  # colour values above 255 reach the clamp
        frames = [_frame(rng, 8, 8, 4.0, 3.5, 3.5, _pose([0.0, 0.0, 0.0]), depth=(0.1, 2.0), color_max=300.0),
                  _frame(rng, 8, 8, 4.0, 3.5, 3.5, _pose([0.0, 0.0, 0.0]), depth=(0.1, 2.0), color_max=300.0)]
        return (25, 17, 13), (-1.5, -1.0, -0.75), 0.125, frames, True
    raise KeyError(name)


CASES = ["zero_depth_rows", "behind_camera", "camera_plane_roundoff", "half_boundaries", "obs_weight",
         "sequence_2", "sequence_3", "color_clamp"]


@pytest.mark.parametrize("name", CASES)
def test_plain_version_matches_jax(name):
    dims, origin, voxel, frames, exact = _case(name)
    (tt, tw, tc), (jt, jw, jc) = _fuse_both(dims, origin, voxel, frames)
    assert (jw > 0).mean() > 0.02  # the frames did touch the volume
    if exact:
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tc, jc)
    else:
        assert (tw != jw).mean() <= FRAC
        assert (np.abs(tt - jt) > 1e-6).mean() <= FRAC
        assert (np.abs(tc - jc) > 1e-3).any(axis=-1).mean() <= FRAC

    cz = _camera_z(dims, np.float32(origin), voxel, frames[0][3])
    if name == "behind_camera":
        assert (cz < 0).mean() > 0.2 and not tw[cz < 0].any()  # nothing behind the camera is updated
    if name == "camera_plane_roundoff":
        assert (np.abs(cz) < 1e-6).sum() > 0  # a plane of voxels within roundoff of cz = 0
    if name == "half_boundaries":
        x = origin[0] + np.arange(dims[0]) * voxel
        z = origin[2] + np.arange(dims[2]) * voxel
        u = 4.0 * x[:, None] / z[None, z > 0] + 3.5
        assert (u - np.floor(u) == 0.5).sum() > 20  # many projections sit on a pixel half-boundary
    if name == "color_clamp":
        assert tc.max() == 255.0 and (tc == 255.0).sum() > 10
    if name == "obs_weight":
        assert set(np.unique(tw)) <= {0.0, 0.5, 2.0, 2.5}


def test_zero_depth_rows_update_nothing():
    """Voxels that project only onto zero-depth rows keep their initial
    state: a frame that is all zero depth updates nothing."""
    dims, origin, voxel, frames, _ = _case("zero_depth_rows")
    d, c, intr, w2c, ow = frames[0]
    zero = (np.zeros_like(d), c, intr, w2c, ow)
    (tt, tw, tc), (jt, jw, jc) = _fuse_both(dims, origin, voxel, [zero])
    assert not tw.any() and not jw.any() and (tt == -1.0).all() and not tc.any()
    (_, tw_rows, _), _ = _fuse_both(dims, origin, voxel, frames)
    (_, tw_full, _), _ = _fuse_both(dims, origin, voxel, [(np.maximum(d, 0.3), c, intr, w2c, ow)])
    assert 0 < (tw_rows > 0).sum() < (tw_full > 0).sum()


def _integrate_before(tsdf, weight, color, depth_im, color_im, intr, w2c, vol_origin, voxel_size, trunc_margin,
                      obs_weight=1.0):
    """``tsdf/fusion.py:integrate_frame`` as it was before the kernel came,
    verbatim: what ``TSDFVolume.integrate`` gave."""
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
    safe_z = torch.where(cz_ == 0, torch.full_like(cz_, 1e-8), cz_)
    u = torch.round(intr[0, 0] * (cx_ / safe_z) + intr[0, 2]).to(torch.int64)
    v = torch.round(intr[1, 1] * (cy_ / safe_z) + intr[1, 2]).to(torch.int64)
    in_frustum = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (cz_ > 0)
    lin = torch.clamp(v, 0, H - 1) * W + torch.clamp(u, 0, W - 1)
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
    color.copy_(torch.where(valid[..., None], torch.clamp(torch.round(
        (color * w_old[..., None] + obs_weight * col) / denom[..., None]), max=255.0), color))
    weight.copy_(w_new)


def test_tsdf_volume_integrate_unchanged_on_the_cpu(monkeypatch):
    """``TSDFVolume.integrate`` after the move gives what it gave before,
    ``torch.equal``, and on the CPU never reaches the kernel's library."""
    monkeypatch.setattr(tsdf_kernel.KERNEL, "lib", lambda: pytest.fail("the CPU loaded K5's library"))
    launches = tsdf_kernel.KERNEL.launches
    rng = np.random.default_rng(3)
    bnds = np.array([[-1.0, 1.0], [-0.8, 0.9], [-0.5, 1.2]])
    vol = TSDFVolume(bnds, 0.06, torch.device("cpu"))
    ref = [t.clone() for t in (vol._tsdf, vol._weight, vol._color)]
    K = np.array([[20.0, 0, 11.5], [0, 20.0, 8.5], [0, 0, 1]], np.float32)
    for k in range(3):
        c2w = np.linalg.inv(_pose([0.1 * k, -0.2, 1.2], 5.0 * k).astype(np.float64))
        d, c, *_ = _frame(rng, 18, 24, 20.0, 11.5, 8.5, np.eye(4), zero_rows=k)
        vol.integrate(c, d, K, c2w, obs_weight=1.0 + 0.5 * k)
        w2c = np.linalg.inv(c2w).astype(np.float32)
        _integrate_before(*ref, torch.tensor(d), torch.tensor(c), torch.tensor(K), torch.tensor(w2c),
                          torch.tensor(vol._vol_origin), vol._voxel_size, vol._trunc_margin, 1.0 + 0.5 * k)
    for got, want in zip((vol._tsdf, vol._weight, vol._color), ref):
        assert torch.equal(got, want)
    assert (ref[1] > 0).float().mean() > 0.02
    assert tsdf_kernel.KERNEL.launches == launches  # the plain version ran: no launch counted


class _CudaTyped(torch.Tensor):
    """A CPU tensor that says it lies on the card: what the wrapper sees of
    a CUDA tensor, on a machine without one."""

    @property
    def device(self):
        return torch.device("cuda")


def _volume_args(cuda: bool):
    rng = np.random.default_rng(4)
    d, c, intr, w2c, ow = _frame(rng, 18, 24, 20.0, 11.5, 8.5, _pose([0.1, -0.2, 1.2]))
    dims = (24, 20, 22)
    arrays = [torch.full(dims, -1.0), torch.zeros(dims), torch.zeros(dims + (3,)), torch.tensor(d), torch.tensor(c),
              torch.tensor(intr), torch.tensor(w2c), torch.tensor([-1.0, -1.0, -0.5])]
    if cuda:
        arrays = [a.as_subclass(_CudaTyped) for a in arrays]
    return arrays, (0.08, 0.4, ow)


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A CUDA-typed call with the library loader made to fail raises, and
    computes nothing on the CPU; only ``plain_on_cuda`` (checks alone)
    routes it to the plain version."""

    def no_library():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")

    monkeypatch.setattr(tsdf_kernel.KERNEL, "lib", no_library)
    calls = []
    plain = tsdf_kernel.integrate_frame_plain
    # records each call; computes only on tensors that really lie on the CPU
    monkeypatch.setattr(tsdf_kernel, "integrate_frame_plain",
                        lambda *a: calls.append(a[0].device.type) or (plain(*a) if a[0].device.type == "cpu" else a[:3]))
    arrays, scalars = _volume_args(cuda=True)
    before = [a.clone() for a in arrays[:3]]
    for fn in (tsdf_kernel.integrate, integrate_frame):
        with pytest.raises(RuntimeError, match="nvcc"):
            fn(*arrays, *scalars)
    assert not calls
    for a, b in zip(arrays[:3], before):
        assert torch.equal(a.as_subclass(torch.Tensor), b.as_subclass(torch.Tensor))  # nothing written
    with tsdf_kernel.plain_on_cuda():
        tsdf_kernel.integrate(*arrays, *scalars)
    assert calls == ["cuda"]
    with pytest.raises(RuntimeError, match="nvcc"):  # only inside the block
        tsdf_kernel.integrate(*arrays, *scalars)

    # the CPU takes the plain version, counts no launch and loads no library
    launches = tsdf_kernel.KERNEL.launches
    arrays, scalars = _volume_args(cuda=False)
    integrate_frame(*arrays, *scalars)
    assert calls == ["cuda", "cpu"] and tsdf_kernel.KERNEL.launches == launches
    assert (arrays[1] > 0).any()


def test_wrapper_checks_what_the_kernel_takes(monkeypatch):
    """Shapes, dtypes, contiguity and a volume the grid cannot cover raise
    before any launch."""
    monkeypatch.setattr(tsdf_kernel.KERNEL, "lib", lambda: pytest.fail("reached the launch"))
    arrays, scalars = _volume_args(cuda=True)
    bad = list(arrays)
    bad[4] = bad[4][..., :2]  # colour image (H, W, 2)
    with pytest.raises(ValueError, match="color_im shape"):
        tsdf_kernel.integrate(*bad, *scalars)
    bad = list(arrays)
    bad[3] = bad[3].double().as_subclass(_CudaTyped)
    with pytest.raises(TypeError, match="float32"):
        tsdf_kernel.integrate(*bad, *scalars)
    bad = list(arrays)
    bad[3] = bad[3].t()
    with pytest.raises(ValueError, match="shape|contiguous"):
        tsdf_kernel.integrate(*bad, *scalars)
    big = [torch.zeros((1, 1, 1)).expand(tsdf_kernel.MAX_XY + 1, 1, 1).as_subclass(_CudaTyped)] + arrays[1:]
    with pytest.raises(ValueError):
        tsdf_kernel.integrate(*big, *scalars)
