"""K5's cull rule (``ops/cuda/tsdf_kernel.py:kept_runs_plain``) held
conservative on the CPU.

The kernel (``csrc/tsdf_integrate.cu``) projects only the voxels of each
(x, y) column's run, the z-range that can lie in front of the camera, in the
image and within the frame's largest depth plus the truncation, widened by
a slack that covers float32 rounding. A voxel outside every run is left
untouched, so the kernel stays bit for bit its plain version only if every
voxel the plain version updates lies in its column's run. Each case here
fuses one frame into a fresh volume through ``integrate_frame_plain`` and
checks that, at the edges the rule's slack is for: pixel half-boundaries,
voxels on the camera plane, NaN / +inf / zero depths, depths beyond the
volume, cameras inside the volume looking every way, and a seeded sweep of
random poses. ``kept_runs_plain`` computes the kernel's runs with the
kernel's double operations; ``chip_smoke.py`` phase 2 holds the kernel's
runs equal to it on the card. One case checks that the rule culls: at phase
2's room0 pose, scaled down, the runs hold some 5 % of the volume.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu.tsdf.fusion import integrate_frame as j_integrate
from attentive_dfprior_tpu_torch.ops.cuda import tsdf_kernel
from attentive_dfprior_tpu_torch.tools import bench
from tests.test_torch_tsdf_kernel import CASES, _case, _frame, _pose


def _fuse(dims, origin, voxel, frame):
    """(X, Y, Z) bool: the voxels the plain version updates, one frame into
    a fresh volume."""
    depth, color, intr, w2c, ow = frame
    t = [torch.full(dims, -1.0), torch.zeros(dims), torch.zeros(dims + (3,))]
    tsdf_kernel.integrate_frame_plain(*t, torch.tensor(depth), torch.tensor(color), torch.tensor(intr),
                                      torch.tensor(w2c), torch.tensor(np.asarray(origin, np.float32)), voxel,
                                      5 * voxel, ow)
    return (t[1] > 0).numpy()


def _runs(dims, origin, voxel, frame):
    depth, _, intr, w2c, _ = frame
    return tsdf_kernel.kept_runs_plain(dims, torch.tensor(np.asarray(origin, np.float32)), voxel,
                                       torch.tensor(w2c), torch.tensor(intr), torch.tensor(depth), 5 * voxel).numpy()


def _inside(runs, Z):
    z = np.arange(Z)
    return (z >= runs[..., :1]) & (z <= runs[..., 1:])


def _held(dims, origin, voxel, frame):
    """Fail unless every voxel the plain version updates lies in its
    column's run; returns (voxels updated, voxels kept)."""
    updated = _fuse(dims, origin, voxel, frame)
    runs = _runs(dims, origin, voxel, frame)
    assert runs.shape == dims[:2] + (2,) and runs.dtype == np.int32
    empty = runs[..., 1] < runs[..., 0]
    assert (runs[empty] == [0, -1]).all()  # an empty run is (0, -1)
    assert (runs[~empty] >= 0).all() and (runs[~empty] < dims[2]).all()
    lost = updated & ~_inside(runs, dims[2])
    assert not lost.any(), f"{int(lost.sum())} updated voxels outside their run, first {np.argwhere(lost)[:3]}"
    return int(updated.sum()), int(np.maximum(runs[..., 1] - runs[..., 0] + 1, 0).sum())


@pytest.mark.parametrize("name", CASES)
def test_runs_hold_the_kernel_cases(name):
    """``tests/test_torch_tsdf_kernel.py``'s cases, each frame alone: odd
    volumes, projections on pixel half-boundaries (exact binary values),
    the camera inside the volume, a z-plane within roundoff of the camera
    plane, zero rows, colour clamps."""
    dims, origin, voxel, frames, exact = _case(name)
    for frame in frames:
        updated, kept = _held(dims, origin, voxel, frame)
        assert updated > 0 and kept < np.prod(dims)
    if exact:  # the JAX package updates exactly these voxels too
        depth, color, intr, w2c, ow = frames[0]
        _, jw, _ = j_integrate(jnp.full(dims, -1.0), jnp.zeros(dims), jnp.zeros(dims + (3,)), jnp.asarray(depth),
                               jnp.asarray(color), jnp.asarray(intr), jnp.asarray(w2c),
                               jnp.asarray(np.asarray(origin, np.float32)), voxel, 5 * voxel, ow)
        assert not (np.asarray(jw) > 0)[~_inside(_runs(dims, origin, voxel, frames[0]), dims[2])].any()


def _look(eye, direction, up=(0.0, 0.0, 1.0)):
    """w2c (float32) of a camera at ``eye`` looking along ``direction``
    (OpenCV: +z forward, +y down)."""
    f = np.asarray(direction, np.float64)
    f /= np.linalg.norm(f)
    up = np.asarray(up, np.float64)
    if abs(f @ up) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    d = np.cross(f, r)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([r, d, f], axis=1)
    c2w[:3, 3] = eye
    return np.linalg.inv(c2w).astype(np.float32)


DIRECTIONS = {"+x": (1, 0, 0), "-x": (-1, 0, 0), "+y": (0, 1, 0), "-y": (0, -1, 0), "+z": (0, 0, 1),
              "-z": (0, 0, -1), "+x+y+z": (1, 1, 1), "-x+y-z": (-1, 1, -1), "+x-y": (1, -1, 0.2),
              "-y+z": (0.1, -1, 1)}


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_runs_hold_inside_the_volume(direction):
    """A camera inside an odd volume looking along each axis and along
    diagonals: the camera plane cuts through the columns, every column
    behind it is cut off, the frustum's four sides cross the columns at
    every angle."""
    rng = np.random.default_rng(list(DIRECTIONS).index(direction))
    dims, origin, voxel = (23, 19, 21), (-1.1, -0.9, -1.0), 0.1
    w2c = _look((0.07, 0.03, 0.09), DIRECTIONS[direction])
    frame = _frame(rng, 14, 18, 9.7, 8.63, 6.41, w2c, depth=(0.2, 1.6))
    updated, kept = _held(dims, origin, voxel, frame)
    assert updated > 100 and kept < 0.7 * np.prod(dims)


@pytest.mark.parametrize("offset", [0.0, 4e-7, -4e-7, 9e-7])
def test_runs_hold_on_the_camera_plane(offset):
    """A plane of voxels at camera z = ``offset``, within 1e-6 of 0 (exactly
    0 at offset 0: binary voxel, origin and pose), the camera looking along
    +z from inside the volume, so those voxels project anywhere."""
    rng = np.random.default_rng(11)
    dims, origin, voxel = (17, 15, 13), (-1.0, -0.875, -0.5 + offset), 0.125
    w2c = _pose([0.0, 0.0, 0.0])
    frame = _frame(rng, 10, 12, 6.0, 5.5, 4.5, w2c, depth=(0.05, 1.2))
    z = np.float32(origin[2]) + np.arange(dims[2], dtype=np.float32) * np.float32(voxel)
    assert (np.abs(z) <= 1e-6).sum() == 1  # one plane of voxels on or next to the camera plane
    updated, _ = _held(dims, origin, voxel, frame)
    assert updated > 0


def test_runs_are_empty_looking_away():
    """A camera outside the volume looking away from it: nothing kept,
    nothing updated."""
    rng = np.random.default_rng(12)
    dims, origin, voxel = (20, 18, 16), (-1.0, -1.0, -1.0), 0.1
    frame = _frame(rng, 12, 16, 10.0, 7.5, 5.5, _look((0.0, 0.0, -1.3), (0.05, -0.03, -1.0)), depth=(0.5, 6.0))
    assert _held(dims, origin, voxel, frame) == (0, 0)


@pytest.mark.parametrize("kind", ["nan", "inf", "zero", "all_zero", "all_nan", "negative"])
def test_runs_hold_odd_depths(kind):
    """NaN pixels (never update), +inf (update with dist = 1 anywhere in
    front: the depth rule is dropped), zero and negative (never update),
    a frame with none valid (nothing kept)."""
    rng = np.random.default_rng(13)
    dims, origin, voxel = (21, 17, 19), (-1.0, -0.8, 0.05), 0.1
    depth, color, intr, w2c, ow = _frame(rng, 12, 16, 10.3, 7.41, 5.63, _pose([0.05, 0.02, 0.0], 4.0),
                                         depth=(0.3, 1.0))
    depth = depth.copy()
    if kind == "nan":
        depth[::3, ::2] = np.nan
    elif kind == "inf":
        depth[5, 7] = np.inf
    elif kind == "zero":
        depth[2:6] = 0.0
    elif kind == "all_zero":
        depth[:] = 0.0
    elif kind == "all_nan":
        depth[:] = np.nan
    elif kind == "negative":
        depth[::2] = -1.0
    frame = (depth, color, intr, w2c, ow)
    updated, kept = _held(dims, origin, voxel, frame)
    state, rules = tsdf_kernel.cull_rules(dims, origin, voxel, w2c, intr, 12, 16,
                                          tsdf_kernel.frame_depth_max(torch.tensor(depth)), 5 * voxel)
    if kind in ("all_zero", "all_nan"):
        assert state == "none" and updated == 0 and kept == 0
    else:
        assert state == "cull" and len(rules) == (5 if kind == "inf" else 6) and updated > 0
    if kind == "inf":  # the ray through pixel (5, 7) updates voxels far beyond the others' depth
        updated_far = _fuse(dims, origin, voxel, frame) & ~_fuse(dims, origin, voxel, (np.where(
            np.isinf(depth), np.float32(1.0), depth), color, intr, w2c, ow))
        assert updated_far.any()


def test_runs_keep_everything_for_a_non_finite_pose():
    """A NaN in the pose: no bound holds, every column's run is the whole
    column (the kernel then projects every voxel, as its first design did)."""
    rng = np.random.default_rng(14)
    dims = (9, 7, 11)
    depth, _, intr, w2c, _ = _frame(rng, 8, 8, 4.0, 3.5, 3.5, _pose([0.0, 0.0, 0.0]))
    w2c = w2c.copy()
    w2c[0, 1] = np.nan
    runs = tsdf_kernel.kept_runs_plain(dims, torch.zeros(3), 0.1, torch.tensor(w2c), torch.tensor(intr),
                                       torch.tensor(depth), 0.5)
    assert (runs[..., 0] == 0).all() and (runs[..., 1] == dims[2] - 1).all()


@pytest.mark.parametrize("far", [False, True])
def test_runs_hold_depths_beyond_the_volume(far):
    """Depths beyond the volume's far side: the depth rule cuts nothing
    inside the volume, the image rules alone bound the runs; the camera
    outside the volume looking into it."""
    rng = np.random.default_rng(15)
    dims, origin, voxel = (19, 23, 17), (-0.9, -1.1, 0.4), 0.1
    frame = _frame(rng, 12, 16, 12.0, 7.7, 5.3, _pose([0.1, -0.05, 0.0], 6.0),
                   depth=(5.0, 9.0) if far else (0.5, 3.0))
    updated, kept = _held(dims, origin, voxel, frame)
    assert updated > 0
    if far:  # every voxel in the frustum is updated: the runs are the frustum plus the slack
        assert updated <= kept <= 1.3 * updated + 4 * dims[0] * dims[1]


def _random_case(rng):
    """A random volume, camera, frame and depth range; cameras inside and
    around the volume, any orientation."""
    dims = tuple(int(n) for n in rng.integers(3, 22, 3))
    voxel = float(rng.uniform(0.04, 0.2))
    origin = tuple(float(x) for x in rng.uniform(-1.5, 0.5, 3))
    center = np.asarray(origin) + voxel * np.asarray(dims) / 2
    eye = center + rng.uniform(-1.5, 1.5, 3) * voxel * np.asarray(dims)
    direction = rng.normal(size=3)
    if rng.random() < 0.6:  # mostly toward the volume
        direction = center - eye + 0.3 * direction
    w2c = _look(eye, direction, up=rng.normal(size=3))
    H, W = (int(n) for n in rng.integers(4, 24, 2))
    fx = float(rng.uniform(0.5, 1.5) * W)
    fy = float(fx * rng.uniform(0.8, 1.25))
    cx, cy = float(W / 2 - 0.5 + rng.uniform(-3, 3)), float(H / 2 - 0.5 + rng.uniform(-3, 3))
    lo = float(rng.uniform(0.0, 1.0))
    depth = rng.uniform(lo, lo + rng.uniform(0.2, 4.0), (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.1] = 0.0
    if rng.random() < 0.2:
        depth[rng.random((H, W)) < 0.1] = np.nan
    color = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    intr = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    return dims, origin, voxel, (depth, color, intr, w2c, 1.0)


@pytest.mark.parametrize("seed", range(10))
def test_runs_hold_random_poses(seed):
    """A seeded sweep of 10 x 25 = 250 random volumes, poses, intrinsics and
    frames."""
    rng = np.random.default_rng(1000 + seed)
    touched = 0
    for _ in range(25):
        dims, origin, voxel, frame = _random_case(rng)
        updated, kept = _held(dims, origin, voxel, frame)
        assert kept >= updated
        touched += updated > 0
    assert touched >= 5  # the sweep does update voxels


def _rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.diag(r))


def _edge_case(rng, edge):
    """A small volume and a frame whose principal point puts one voxel's
    exact projection within float32 roundoff of the image's ``edge`` (u or
    v = -0.5, or W - 0.5 / H - 0.5), so that the rounded projection falls
    on either side of the edge as the exact one does, independently."""
    dims, voxel = (6, 5, 7), float(rng.uniform(0.03, 0.2))
    origin = tuple(float(x) for x in rng.uniform(-0.5, 0.5, 3))
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = _rotation(rng) if rng.random() < 0.5 else np.eye(3)
    w2c[:3, 3] = rng.uniform(-0.3, 0.3, 3)
    w2c[2, 3] += 1.5
    H, W = (int(n) for n in rng.integers(6, 20, 2))
    fx, fy = float(rng.uniform(5, 40)), float(rng.uniform(5, 40))
    idx = rng.integers(0, dims)
    p = np.asarray(origin, np.float32) + idx.astype(np.float32) * np.float32(voxel)
    c = w2c[:3, :3].astype(np.float64) @ p + w2c[:3, 3]
    axis = 0 if edge in ("left", "right") else 1
    target = {"left": -0.5, "right": W - 0.5, "top": -0.5, "bottom": H - 0.5}[edge]
    f = (fx, fy)[axis]
    centre = [W / 2 - 0.5 - f * c[0] / c[2], H / 2 - 0.5 - f * c[1] / c[2]]  # the voxel mid-image
    centre[axis] = target - f * c[axis] / c[2]  # ... but on the edge
    intr = np.array([[fx, 0, centre[0]], [0, fy, centre[1]], [0, 0, 1]], np.float32)
    depth = np.full((H, W), np.float32(rng.uniform(3.0, 5.0)))
    return dims, origin, voxel, (depth, np.zeros((H, W, 3), np.float32), intr, w2c, 1.0), tuple(int(i) for i in idx)


@pytest.mark.parametrize("edge", ["left", "right", "top", "bottom"])
def test_runs_hold_at_the_image_edges(edge):
    """60 voxels each projecting within roundoff of the image's edge: the
    rounded projection decides (half to even at -0.5), the rule's one-pixel
    margin must keep every one the plain version accepts."""
    rng = np.random.default_rng(["left", "right", "top", "bottom"].index(edge) + 50)
    hits = 0
    for _ in range(60):
        dims, origin, voxel, frame, idx = _edge_case(rng, edge)
        _held(dims, origin, voxel, frame)
        hits += bool(_fuse(dims, origin, voxel, frame)[idx])
    assert 5 <= hits <= 55  # the edge voxel is accepted in some trials and not in others


@pytest.mark.parametrize("seed", range(4))
def test_runs_hold_a_voxel_at_the_camera_centre(seed):
    """50 cameras, each placed on a voxel's world position in any
    orientation: that voxel's camera coordinates are float32 roundoff
    (about 1e-8, of either sign), its projection anywhere; the plain
    version updates it where the rounded c.z > 0 and the pixel lands in the
    frame, which the rule must keep whatever the exact signs."""
    rng = np.random.default_rng(200 + seed)
    hits = 0
    for _ in range(50):
        dims, voxel = (5, 6, 5), float(rng.uniform(0.05, 0.3))
        origin = tuple(float(x) for x in rng.uniform(-1.0, 1.0, 3))
        idx = rng.integers(0, dims)
        p = np.asarray(origin, np.float32) + idx.astype(np.float32) * np.float32(voxel)
        rot = _rotation(rng).astype(np.float32)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = rot
        w2c[:3, 3] = -(rot.astype(np.float64) @ p.astype(np.float64))
        H, W = 16, 16
        frame = _frame(rng, H, W, float(rng.uniform(0.3, 3.0)), 7.5, 7.5, w2c, depth=(0.5, 2.0))
        _held(dims, origin, voxel, frame)
        hits += bool(_fuse(dims, origin, voxel, frame)[tuple(idx)])
    assert hits > 0  # the centre voxel itself is updated in some trials


def test_rule_culls_at_the_room0_pose():
    """Phase 2's room0 frame (``chip_smoke.py:kernel_k5``: camera at
    (2, 1, 0) looking along +z, depth uniform in [0.5, 4] m) at 1/8 of the
    resolution (voxel 1/8 m, a 85 x 150 frame): the runs hold under 30 % of
    the volume (some 5 %), and every updated voxel."""
    w = bench.WORKLOADS["replica"]
    bound = np.asarray(w["bound"])
    voxel = bench.VOXEL * 8
    dims = bench.prior_dims(bound, voxel)
    cam = w["cam"]
    intr = np.array([[cam["fx"] / 8, 0, (cam["cx"] + 0.5) / 8 - 0.5], [0, cam["fy"] / 8, (cam["cy"] + 0.5) / 8 - 0.5],
                     [0, 0, 1]], np.float32)
    c2w = np.eye(4)
    c2w[:3, 3] = [2.0, 1.0, 0.0]
    rng = np.random.default_rng(6)
    H, W = cam["H"] // 8, cam["W"] // 8
    frame = (rng.uniform(0.5, 4.0, (H, W)).astype(np.float32), rng.uniform(0, 255, (H, W, 3)).astype(np.float32),
             intr, np.linalg.inv(c2w).astype(np.float32), 1.0)
    updated, kept = _held(dims, tuple(bound[:, 0]), voxel, frame)
    share = kept / np.prod(dims)
    assert share < 0.30 and kept < 4 * updated, (share, kept, updated)


def test_scratch_is_made_once_a_shape(monkeypatch):
    """The kernel's scratch is cached by (device, stream): a second call at
    a shape (or a smaller one) gets the same buffer, a larger volume or
    frame grows it once."""
    monkeypatch.setattr(tsdf_kernel, "_SCRATCH", {})

    class Lib:
        tsdf_scratch_words = staticmethod(lambda X, Y, Z, H, W: 516 + 4 * H * W + 2 * X * Y * -(-Z // tsdf_kernel.CHUNK))

    dev = torch.device("cpu")
    a = tsdf_kernel._scratch(Lib, dev, 7, 10, 9, 300, 6, 8)
    assert a.numel() == 516 + 4 * 48 + 2 * 90 * 3 and not a.any()
    assert tsdf_kernel._scratch(Lib, dev, 7, 10, 9, 300, 6, 8) is a
    assert tsdf_kernel._scratch(Lib, dev, 7, 5, 9, 100, 4, 8) is a
    b = tsdf_kernel._scratch(Lib, dev, 8, 10, 9, 300, 6, 8)  # another stream, its own
    assert b is not a
    c = tsdf_kernel._scratch(Lib, dev, 7, 20, 9, 300, 6, 8)
    assert c.numel() > a.numel() and tsdf_kernel._scratch(Lib, dev, 7, 10, 9, 300, 6, 8) is c
    d = tsdf_kernel._scratch(Lib, dev, 7, 20, 9, 300, 60, 80)  # a larger frame
    assert d.numel() > c.numel() and tsdf_kernel._scratch(Lib, dev, 7, 20, 9, 300, 6, 8) is d


def test_wrapper_checks_the_list_limits():
    """Z above 65535 (the item's 16 bits) raises before any launch, as X and
    Y do."""
    with pytest.raises(ValueError, match="dimension above"):
        tsdf_kernel._check_dims(4, 4, tsdf_kernel.MAX_XY + 1)
    tsdf_kernel._check_dims(758, 574, 451)  # room0
