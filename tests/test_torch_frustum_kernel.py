"""K6, the mapper's frustum masks (``ops/cuda/frustum_kernel.py``), held on
the CPU.

The kernel (``csrc/frustum_mask.cu``) runs only on the card. Its operation
order is ``frustum_masks_plain``: the tests hold that, voxel for voxel, to
``slam/mapper.py:get_frustum_mask`` (numpy, the CPU route and the JAX
package's) at room0's and ScanNet's lattices over seeded frames and at the
edges of the rule: zero-depth patches, an all-zero frame, NaN and +inf
pixels, a camera inside the lattice (the distance rule), a camera facing
out of the bound, and non-finite poses. numpy's BLAS may round the 4x4 or
3x3 product differently in the last place; a mask can then differ only
where a value lies that close to a threshold, and a failing case reports
each such voxel with its margins. ``pack``'s host numbers (the inverse
pose, the lattices as ``np.linspace`` makes them, the high and colour
grids' shared lattice) and the mapper's CPU route are tested here too;
``chip_smoke.py`` phase 2 holds the kernel bit for bit to the plain version
on the card.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from attentive_dfprior_tpu_torch.camera import Camera
from attentive_dfprior_tpu_torch.config import default_config_path, load_config
from attentive_dfprior_tpu_torch.models.scene import load_bound
from attentive_dfprior_tpu_torch.ops.cuda import frustum_kernel as K6
from attentive_dfprior_tpu_torch.slam.mapper import _bilinear_sample_border0, get_frustum_mask
from test_torch_imports import REPO

CONFIGS = {"room0": os.path.join("configs", "Replica", "room0.yaml"),
           "scannet": os.path.join("configs", "ScanNet", "scene0000.yaml")}
# the lattices of each configuration: its low and high (= colour) grids; for
# ScanNet also 40x42x23 and 81x84x46, one cell fewer a side than its bound gives
LATTICES = {"room0": [(37, 28, 22), (74, 56, 44), (74, 56, 44)],
            "scannet": [(41, 43, 24), (82, 86, 48), (82, 86, 48)],
            "scannet_cut": [(40, 42, 23), (81, 84, 46), (81, 84, 46)]}
FRAMES = 12


def _setup(name):
    """(camera, bound) of configuration ``name``."""
    cfg = load_config(os.path.join(REPO, CONFIGS[name.split("_")[0]]), default_config_path())
    return Camera.from_config(cfg), load_bound(cfg)


def _look(eye, forward):
    """c2w (float32) of a camera at ``eye`` looking along ``forward``
    (the mapper's convention: the camera looks along its -z)."""
    f = np.asarray(forward, np.float64)
    f /= np.linalg.norm(f)
    up = np.array([0.0, 0.0, 1.0]) if abs(f[2]) < 0.95 else np.array([0.0, 1.0, 0.0])
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([r, np.cross(r, f), -f], axis=1)
    c2w[:3, 3] = eye
    return c2w.astype(np.float32)


def _frame(rng, cam, bound, depth_range=(0.3, 6.0), patches=3):
    """A seeded frame: a pose inside the bound looking a random way, depth
    uniform in ``depth_range`` with ``patches`` rectangles of zero depth."""
    eye = bound[:, 0] + rng.uniform(0.1, 0.9, 3) * (bound[:, 1] - bound[:, 0])
    d = rng.standard_normal(3)
    d[2] *= 0.3
    depth = rng.uniform(*depth_range, (cam.H, cam.W)).astype(np.float32)
    for _ in range(patches):
        v, u = rng.integers(0, cam.H), rng.integers(0, cam.W)
        depth[v: v + rng.integers(5, cam.H // 3), u: u + rng.integers(5, cam.W // 3)] = 0.0
    return _look(eye, d), depth


def _terms(c2w, shape, bound, depth, cam):
    """``get_frustum_mask``'s intermediate values, flat: u, v (float32), -z,
    the depth threshold (float32), the squared distance to the camera."""
    axes = [np.linspace(bound[a][0], bound[a][1], shape[a]) for a in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    w2c = np.linalg.inv(c2w.astype(np.float64))
    cc = (w2c @ np.concatenate([pts, np.ones((len(pts), 1))], axis=1).T).T[:, :3]
    cc[:, 0] *= -1
    uv = (cam.K @ cc.T).T
    z = uv[:, 2] + 1e-5
    uv = (uv[:, :2] / z[:, None]).astype(np.float32)
    d = _bilinear_sample_border0(np.asarray(depth, np.float32), uv[:, 0], uv[:, 1])
    if (d == 0).any():
        d[d == 0] = d.max()
    return uv[:, 0], uv[:, 1], -z, d + 0.5, np.sum((pts - c2w[:3, 3]) ** 2, axis=1)


def _held(c2w, depth, cam, bound, shapes):
    """Fail unless the plain version equals ``get_frustum_mask`` at every
    grid, reporting each voxel that differs with its margins; returns the
    numpy masks."""
    packed = K6.pack(c2w, shapes, bound, cam)
    plain = K6.frustum_masks_plain(packed, torch.from_numpy(depth))
    refs = []
    for shape, got in zip(shapes, plain):
        ref = get_frustum_mask(c2w, shape, bound, depth, cam)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        assert set(got.unique().tolist()) <= {0.0, 1.0}
        diff = np.flatnonzero(got.numpy().astype(bool) != ref)
        if diff.size:
            u, v, nz, thr, dist2 = (t[diff] for t in _terms(c2w, shape, bound, depth, cam))
            margins = [dict(voxel=int(i), plain=float(got.reshape(-1)[i]), numpy=bool(ref.reshape(-1)[i]),
                            u=float(a), u_to_W=float(cam.W - a), v=float(b), v_to_H=float(cam.H - b),
                            minus_z=float(c), minus_z_to_depth=float(d) - float(c), dist2_to_quarter=float(e) - 0.25)
                       for i, a, b, c, d, e in list(zip(diff, u, v, nz, thr, dist2))[:10]]
            pytest.fail(f"{diff.size} of {ref.size} voxels differ at grid {shape}; margins: {margins}")
        refs.append(ref)
    return refs


@pytest.mark.parametrize("name", sorted(LATTICES))
@pytest.mark.parametrize("frame", range(FRAMES))
def test_plain_equals_numpy_on_seeded_frames(name, frame):
    cam, bound = _setup(name)
    rng = np.random.default_rng([frame, len(name)])
    c2w, depth = _frame(rng, cam, bound)
    refs = _held(c2w, depth, cam, bound, LATTICES[name])
    assert all(r.any() for r in refs)  # every grid keeps something: the camera looks into the bound


def _edge(name, cam, bound):
    """(c2w, depth) of edge case ``name``."""
    rng = np.random.default_rng(7)
    mid = bound.mean(axis=1)
    depth = rng.uniform(0.3, 6.0, (cam.H, cam.W)).astype(np.float32)
    if name == "zero_patches":
        depth[: cam.H // 2, : cam.W // 3] = 0.0
        depth[cam.H // 3:, cam.W // 2: cam.W // 2 + 40] = 0.0
        return _look(mid, (1.0, 0.3, 0.1)), depth
    if name == "all_zero":
        return _look(mid, (0.2, 1.0, -0.1)), np.zeros_like(depth)
    if name == "nan_inf_pixels":
        depth[::7, ::5] = np.nan
        depth[3, 11] = depth[100, 50] = np.inf
        return _look(mid, (-1.0, 0.2, 0.0)), depth
    if name == "inside_all_zero":  # every sample 0: kept within 0.5 m in front, and by the distance rule
        return _look(mid + 0.013, (0.0, 0.0, 1.0)), np.zeros_like(depth)
    if name == "inside_near":
        return _look(mid + 0.037, (0.3, -1.0, 0.2)), rng.uniform(0.05, 0.3, depth.shape).astype(np.float32)
    if name == "facing_out":  # at the bound's edge looking outward: the distance rule keeps what is kept
        eye = mid.copy()
        eye[0] = bound[0, 1] - 0.1
        return _look(eye, (1.0, 0.05, 0.02)), depth
    if name == "on_a_lattice_point":  # the camera centre exactly on a lattice point
        eye = np.array([np.linspace(bound[a, 0], bound[a, 1], 37 if a == 0 else 28 if a == 1 else 22)[9]
                        for a in range(3)])
        return _look(eye, (0.5, 1.0, 0.0)), depth
    if name == "nan_pose":
        c2w = _look(mid, (1.0, 0.0, 0.0))
        c2w[0, 1] = np.nan
        return c2w, depth
    if name == "inf_translation":
        c2w = _look(mid, (1.0, 0.0, 0.0))
        c2w[1, 3] = np.inf
        return c2w, depth
    raise KeyError(name)


EDGES = ("zero_patches", "all_zero", "nan_inf_pixels", "inside_all_zero", "inside_near", "facing_out",
         "on_a_lattice_point", "nan_pose", "inf_translation")


@pytest.mark.parametrize("case", EDGES)
def test_plain_equals_numpy_at_the_edges(case):
    cam, bound = _setup("room0")
    c2w, depth = _edge(case, cam, bound)
    refs = _held(c2w, depth, cam, bound, LATTICES["room0"])
    kept = [int(r.sum()) for r in refs]
    with np.errstate(invalid="ignore"):
        near = (_terms(c2w, LATTICES["room0"][1], bound, depth, cam)[4] < 0.25).reshape(LATTICES["room0"][1])
    if case in ("inside_all_zero", "inside_near", "facing_out", "nan_pose"):
        # the distance rule at work: voxels within 0.5 m of the camera are kept
        assert near.any() and refs[1][near].all()
    if case == "nan_pose":  # nothing projects: the distance rule alone keeps voxels
        assert kept[1] == int(near.sum())
    if case == "inf_translation":
        assert kept == [0, 0, 0]


def _cam():
    return Camera(H=30, W=40, fx=23.7, fy=24.1, cx=19.63, cy=14.41)


@pytest.mark.parametrize("n", [1, 2, 3, 22, 37, 74, 81])
def test_pack_lattice_is_numpys_linspace(n):
    bound = np.array([[-2.9, 8.94], [-3.2, 5.760000000000001], [-2.0, 5.68]])
    packed = K6.pack(np.eye(4, dtype=np.float32), [(n, n + 1, max(n - 1, 1))], bound, _cam())
    axes = K6.lattice_axes(packed, 0)
    for a, m in enumerate((n, n + 1, max(n - 1, 1))):
        want = np.linspace(bound[a, 0], bound[a, 1], m)
        assert axes[a].dtype == torch.float64 and np.array_equal(axes[a].numpy(), want), (a, m)
    start, step, stop = (packed.params[K6.HEAD + 3 * i: K6.HEAD + 3 * i + 3] for i in range(3))
    assert np.array_equal(start, bound[:, 0]) and np.array_equal(stop, bound[:, 1])
    assert step[0] == ((bound[0, 1] - bound[0, 0]) / (n - 1) if n > 1 else 0.0)


def test_pack_head_holds_numpys_inverse_the_intrinsics_and_the_centre():
    rng = np.random.default_rng(3)
    cam = _cam()
    c2w = _look(rng.uniform(-1, 1, 3), rng.standard_normal(3))
    packed = K6.pack(c2w, [(4, 5, 6)], np.array([[-1.0, 1.0]] * 3), cam)
    p = packed.params
    assert p.dtype == np.float64 and p.shape == (K6.HEAD + 9,)
    assert np.array_equal(p[:16], np.linalg.inv(c2w.astype(np.float64)).reshape(-1))
    assert np.array_equal(p[16:25], cam.K.reshape(-1))
    assert np.array_equal(p[25:28], c2w[:3, 3].astype(np.float64))
    assert p[28] == cam.W and p[29] == cam.H
    assert packed.dims.dtype == np.int32 and packed.dims.tolist() == [[4, 5, 6]]


@pytest.mark.parametrize("shapes,groups", [
    ([(37, 28, 22), (74, 56, 44), (74, 56, 44)], [[0], [1, 2]]),
    ([(4, 5, 6), (8, 10, 12), (8, 10, 11)], [[0], [1], [2]]),
    ([(4, 5, 6), (4, 5, 6), (4, 5, 6)], [[0, 1, 2]]),
])
def test_pack_shares_a_lattice_between_grids_of_one_shape(shapes, groups):
    cam = _cam()
    bound = np.array([[-1.0, 1.5], [-1.2, 0.9], [-0.7, 1.1]])
    c2w = _look((0.1, -0.2, 0.05), (0.3, 1.0, 0.1))
    packed = K6.pack(c2w, shapes, bound, cam)
    assert packed.groups == groups
    assert packed.dims.tolist() == [list(shapes[g[0]]) for g in groups]
    assert packed.params.shape == (K6.HEAD + 9 * len(groups),)
    depth = np.random.default_rng(0).uniform(0.2, 2.0, (cam.H, cam.W)).astype(np.float32)
    masks = K6.frustum_masks_plain(packed, torch.from_numpy(depth))
    for g in groups:
        assert all(masks[i] is masks[g[0]] for i in g)
    _held(c2w, depth, cam, bound, shapes)


def test_pack_refuses_more_lattices_than_the_kernel_takes():
    with pytest.raises(ValueError, match="lattices"):
        K6.pack(np.eye(4), [(2, 2, 2), (3, 3, 3), (4, 4, 4), (5, 5, 5)], np.array([[-1.0, 1.0]] * 3), _cam())


def test_the_wrapper_takes_cuda_tensors_alone():
    packed = K6.pack(np.eye(4), [(2, 3, 4)], np.array([[-1.0, 1.0]] * 3), _cam())
    with pytest.raises(ValueError, match="device"):
        K6.frustum_masks(packed, torch.zeros((30, 40)), [torch.zeros(24)])
    assert K6.KERNEL.launches == 0


def test_k6_is_a_port_kernel_built_before_the_steps():
    from attentive_dfprior_tpu_torch.ops.cuda.build import port_kernels, step_kernels

    assert K6.KERNEL in port_kernels() and K6.KERNEL in step_kernels()
    assert os.path.exists(K6.KERNEL.source)


def test_optimize_map_takes_the_numpy_route_on_the_cpu():
    """On the CPU the mapper computes its masks with ``get_frustum_mask``:
    the span says so, and the static buffers the stages read hold them."""
    from attentive_dfprior_tpu_torch.models.scene import SceneConfig, init_scene
    from attentive_dfprior_tpu_torch.render.renderer import RenderConfig
    from attentive_dfprior_tpu_torch.slam.mapper import GRID_KEYS, Mapper
    from attentive_dfprior_tpu_torch.utils.profiling import recording, spans
    from test_torch_slam import tiny_room_cfg

    cfg = tiny_room_cfg()
    cfg["mapping"].update(iters_first=3, iters=3)
    cam = Camera.from_config(cfg)
    scfg = SceneConfig.from_config(cfg, pretrained_loaded=False)
    params = init_scene(torch.Generator().manual_seed(0), scfg)
    bnds = np.asarray(scfg.bound, np.float32)
    vol = torch.rand((8, 8, 8), generator=torch.Generator().manual_seed(1)) * 2 - 1
    m = Mapper(cfg, cam, scfg, RenderConfig(N_samples=8, N_surface=4), vol, bnds, torch.device("cpu"))
    assert m.frustum_feature_selection
    rng = np.random.default_rng(2)
    c2w = _look(scfg.bound.mean(axis=1), (1.0, 0.2, 0.0))
    depth = rng.uniform(0.5, 3.0, (cam.H, cam.W)).astype(np.float32)
    color = torch.rand((1, cam.H, cam.W, 3), generator=torch.Generator().manual_seed(3))
    with recording():
        m.optimize_map(params, 3, 1.0, 5, color, torch.from_numpy(depth)[None], c2w[None],
                       generator=torch.Generator().manual_seed(4), cur_depth_np=depth, cur_c2w_np=c2w)
    (s,) = [s for s in spans() if s.name == "Mapper.frustum_masks"]
    assert s.attrs == {"route": "numpy"}
    for k in GRID_KEYS:
        buf = m.graphs.buffers[("frustum", k)]
        want = get_frustum_mask(c2w, tuple(params[k].shape[:3]), np.asarray(scfg.bound), depth, cam)
        assert buf.dtype == torch.float32 and torch.equal(buf[..., 0], torch.from_numpy(want).float())
    assert K6.KERNEL.launches == 0
