"""The port's meshing path against the JAX package, on the CPU, at small
sizes (grids of a few voxels, mesher lattices of at most 32^3):

  - PLY files: the same bytes, read back the same;
  - marching tetrahedra: the numpy route equal to the JAX package's on an
    analytic sphere SDF; the native route (g++, built on first use) equal
    to the numpy route up to vertex order; asking for the native route
    without a compiler raises;
  - the observedness fills and ``TSDFVolume.get_mesh``: bit-exact on the
    same volumes;
  - ``Mesher.get_mesh`` on a scene carried across from the JAX package:
    each package queries its own field (the two agree to float32 roundoff),
    and the meshes have the same faces and vertices within 1e-6; with one
    shared field the written PLY files are byte-identical;
  - ``SyntheticScene.gt_mesh``, ``cull_mesh``, ``unseen_pointcloud``,
    ``calc_3d_metric`` and ``calc_2d_metric``: equal on the same meshes;
  - the system's side outputs and the TSDF builder's CLI on a tiny run.
"""

from __future__ import annotations

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu.utils import marching_cubes as JMC
from attentive_dfprior_tpu.utils import ply as JPLY
from attentive_dfprior_tpu_torch import native
from attentive_dfprior_tpu_torch.utils import marching_cubes as TMC
from attentive_dfprior_tpu_torch.utils import ply as TPLY
from test_torch_jax_native import jax_native, jax_native_build  # noqa: F401 (fixtures)
from test_torch_slam import setup, tiny_room_cfg  # noqa: F401 (setup is a fixture)


def sphere_volume(n=24, r=8.0):
    g = np.mgrid[0:n, 0:n, 0:n].astype(float)
    return r - np.sqrt(((g - n / 2) ** 2).sum(0))


def oriented_triangles(verts, faces):
    """Each face's three vertex positions, rotated to start at its smallest
    vertex (orientation kept), sorted: the surface without vertex order."""
    tris = verts[faces]
    out = []
    for tri in tris:
        k = min(range(3), key=lambda i: tuple(tri[i]))
        out.append(tuple(map(tuple, np.roll(tri, -k, axis=0))))
    return sorted(out)


def _jax_native_available() -> bool:
    from attentive_dfprior_tpu import native as jnative

    return jnative.available()


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mesh_colors", "mesh_normals", "ascii", "points"])
def test_ply_bytes_match_jax(kind, tmp_path):
    rng = np.random.default_rng(0)
    verts = rng.standard_normal((50, 3))
    faces = rng.integers(0, 50, (30, 3)).astype(np.int64)
    colors = rng.integers(0, 255, (50, 3)).astype(np.uint8)
    normals = rng.standard_normal((50, 3))
    kw = {
        "mesh_colors": dict(faces=faces, colors=colors),
        "mesh_normals": dict(faces=faces, colors=colors, normals=normals),
        "ascii": dict(faces=faces, colors=colors, binary=False),
        "points": dict(normals=normals),
    }[kind]
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    JPLY.write_ply(pj, verts, **kw)
    TPLY.write_ply(pt, verts, **kw)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    for a, b in zip(JPLY.read_ply(pj), TPLY.read_ply(pt)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# marching tetrahedra
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level,spacing", [(0.0, (1.0, 1.0, 1.0)), (2.0, (0.5, 0.25, 0.5))])
def test_marching_cubes_numpy_matches_jax(level, spacing):
    vol = sphere_volume()
    ref = JMC.marching_cubes_numpy(vol, level, spacing)
    got = TMC.marching_cubes_numpy(vol, level, spacing)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    assert len(got[1]) > 1000


def test_native_route_matches_numpy_route():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native route cannot be built here")
    vol = sphere_volume(24, 8.0)
    v_np, f_np, n_np = TMC.marching_cubes(vol, 0.5, (0.5, 0.5, 1.0), use_native=False)
    v_nat, f_nat, n_nat = TMC.marching_cubes(vol, 0.5, (0.5, 0.5, 1.0), use_native=True)
    assert len(v_np) == len(v_nat) and len(f_np) == len(f_nat)
    assert oriented_triangles(v_np, f_np) == oriented_triangles(v_nat, f_nat)
    empty = TMC.marching_cubes(-np.ones((6, 6, 6)), 0.0, use_native=True)
    assert len(empty[0]) == 0 and len(empty[1]) == 0


def test_native_route_raises_when_it_cannot_build(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "lib_path", lambda: str(tmp_path / "missing.so"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        TMC.marching_cubes(sphere_volume(8, 3.0), 0.0, use_native=True)
    TMC.marching_cubes(sphere_volume(8, 3.0), 0.0, use_native=False)  # the numpy route needs none


# ---------------------------------------------------------------------------
# TSDF volume: fills and mesh
# ---------------------------------------------------------------------------


def _fused_like_volume(rng, shape=(14, 12, 10)):
    """A TSDF with an observed band around a sphere, -1 (the init) outside
    the observed region, and some observed voxels clamped at exactly -1."""
    g = np.stack(np.meshgrid(*[np.arange(n) for n in shape], indexing="ij"), axis=-1).astype(np.float32)
    sdf = np.linalg.norm(g - np.array(shape) / 2, axis=-1) - 3.5
    tsdf = np.clip(sdf / 2.0, -1, 1).astype(np.float32)
    observed = g[..., 0] < shape[0] * 0.7
    tsdf[~observed] = -1.0
    weight = np.where(observed, rng.integers(1, 4, shape), 0).astype(np.float32)
    color = rng.integers(0, 256, shape + (3,)).astype(np.float32)
    return tsdf, observed, weight, color


@pytest.mark.parametrize("mode", ["free", "nearest", "reference"])
def test_fill_unobserved_volume_and_legacy_mask_match_jax(mode):
    from attentive_dfprior_tpu.tsdf.fusion import fill_unobserved_volume as j_fill
    from attentive_dfprior_tpu.tsdf.fusion import legacy_observed_mask as j_legacy
    from attentive_dfprior_tpu_torch.tsdf.fusion import fill_unobserved_volume, legacy_observed_mask

    tsdf, observed, _, _ = _fused_like_volume(np.random.default_rng(1))
    np.testing.assert_array_equal(fill_unobserved_volume(tsdf, observed, mode), j_fill(tsdf, observed, mode))
    legacy = legacy_observed_mask(tsdf)
    np.testing.assert_array_equal(legacy, j_legacy(tsdf))
    assert legacy.any() and not legacy.all()


def test_tsdf_volume_mesh_matches_jax():
    """Both volumes hold the same fused arrays (the fusion itself is tested
    in tests/test_torch_ops.py): get_mesh and get_point_cloud agree."""
    from attentive_dfprior_tpu.tsdf.fusion import TSDFVolume as JVolume
    from attentive_dfprior_tpu_torch.tsdf.fusion import TSDFVolume

    tsdf, _, weight, color = _fused_like_volume(np.random.default_rng(2))
    bnds = np.array([[-1.0, 0.75], [-0.5, 1.0], [0.0, 1.25]])  # 14 x 12 x 10 voxels of 0.125
    jv = JVolume(bnds, voxel_size=0.125)
    tv = TSDFVolume(bnds, voxel_size=0.125, device=torch.device("cpu"))
    assert tuple(tv._tsdf.shape) == tsdf.shape
    jv._tsdf, jv._weight, jv._color = jnp.asarray(tsdf), jnp.asarray(weight), jnp.asarray(color)
    tv._tsdf, tv._weight, tv._color = torch.tensor(tsdf), torch.tensor(weight), torch.tensor(color)
    ref = jv.get_mesh()
    got = tv.get_mesh(use_native=_jax_native_available())
    assert len(got[1]) > 100
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tv.get_point_cloud(use_native=_jax_native_available()), jv.get_point_cloud())


# ---------------------------------------------------------------------------
# Mesher
# ---------------------------------------------------------------------------


def _meshers(s, resolution=24):
    from attentive_dfprior_tpu.camera import Camera as JCamera
    from attentive_dfprior_tpu.utils.mesher import Mesher as JMesher
    from attentive_dfprior_tpu_torch.camera import Camera
    from attentive_dfprior_tpu_torch.utils.mesher import Mesher

    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in s["cfg"].items()}
    cfg["meshing"] = dict(cfg["meshing"], resolution=resolution)
    jcfg = dict(s["jcfg"], meshing=cfg["meshing"])
    bound = np.asarray(s["scfg"].bound, np.float32)
    jm = JMesher(jcfg, JCamera.from_config(jcfg), bound, s["tsdf_bnds"], points_batch_size=4096)
    tm = Mesher(cfg, Camera.from_config(cfg), bound, s["tsdf_bnds"], torch.device("cpu"), points_batch_size=4096,
                use_native=_jax_native_available())
    return jm, tm


def _carried_scene(s):
    """The JAX init carried over, with the grids roughened so that the
    field has structure at this tiny size."""
    rng = np.random.default_rng(5)
    params = dict(s["params0"])
    for k in ("grid_low", "grid_high", "grid_color"):
        params[k] = (params[k] + 0.3 * rng.standard_normal(params[k].shape)).astype(np.float32)
    kf = [s["frames"][i] for i in (0, 2)]
    return params, np.stack([f[2] for f in kf]), np.stack([f[3] for f in kf])


@pytest.mark.parametrize("all_frames", [False, True])
def test_mesher_matches_jax_on_a_carried_scene(setup, tmp_path, all_frames):
    from attentive_dfprior_tpu.ops.grid_sample import tsdf_to_rows
    from attentive_dfprior_tpu_torch.models.scene import params_from_numpy

    jm, tm = _meshers(setup)
    params, kf_depths, kf_c2w = _carried_scene(setup)
    est = np.stack([f[3] for f in setup["frames"]])
    jv, jf = jm.get_mesh(str(tmp_path / "j.ply"), jax.tree_util.tree_map(jnp.asarray, params),
                         tsdf_to_rows(setup["vol"]), kf_depths, kf_c2w, est, 2, get_mask_use_all_frames=all_frames)
    tv, tf = tm.get_mesh(str(tmp_path / "t.ply"), params_from_numpy(params), torch.tensor(setup["vol"]),
                         kf_depths, kf_c2w, est, 2, get_mask_use_all_frames=all_frames)
    assert len(tf) > 500
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    _, _, jc = JPLY.read_ply(str(tmp_path / "j.ply"))
    _, _, tc = TPLY.read_ply(str(tmp_path / "t.ply"))
    assert np.abs(tc.astype(int) - jc.astype(int)).max() <= 1  # uint8 of a float32 color
    assert set(tm.last_timings) == {"field_s", "host_s", "total_s"}


def test_mesher_with_one_shared_field_writes_the_same_bytes(setup, tmp_path):
    """Both meshers query one analytic field (a sphere and a plane): every
    host step, from the hull to the PLY bytes, is the same."""
    jm, tm = _meshers(setup, resolution=28)
    _, kf_depths, kf_c2w = _carried_scene(setup)

    def field(params, points, tsdf_volume, stage="high"):
        p = np.asarray(points, np.float64)
        sdf = np.minimum(np.linalg.norm(p - np.array([0.3, -0.4, 0.2]), axis=1) - 0.6, p[:, 1] + 1.2)
        rgb = 0.5 + 0.4 * np.sin(3.0 * p)
        return np.concatenate([rgb, -10.0 * sdf[:, None]], axis=1).astype(np.float32)

    jm.eval_points = field
    tm.eval_points = field
    est = np.stack([f[3] for f in setup["frames"]])
    jm.get_mesh(str(tmp_path / "j.ply"), None, None, kf_depths, kf_c2w, est, 2)
    tm.get_mesh(str(tmp_path / "t.ply"), None, None, kf_depths, kf_c2w, est, 2)
    data = open(tmp_path / "t.ply", "rb").read()
    assert len(TPLY.read_ply(str(tmp_path / "t.ply"))[1]) > 100
    assert data == open(tmp_path / "j.ply", "rb").read()


# ---------------------------------------------------------------------------
# GT mesh and evaluation tools
# ---------------------------------------------------------------------------


def test_synthetic_gt_mesh_matches_jax(monkeypatch):
    from attentive_dfprior_tpu.utils.synthetic import SyntheticScene as JScene
    from attentive_dfprior_tpu_torch.utils.synthetic import SyntheticScene

    monkeypatch.setattr(JMC, "marching_cubes", lambda *a, **kw: JMC.marching_cubes_numpy(*a, **kw))
    ref = JScene().gt_mesh(resolution=20)
    got = SyntheticScene().gt_mesh(resolution=20, use_native=False)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def _two_meshes():
    from attentive_dfprior_tpu_torch.utils.synthetic import SyntheticScene

    gt_v, gt_f, _ = SyntheticScene().gt_mesh(resolution=24, use_native=False)
    rng = np.random.default_rng(3)
    rec_v = gt_v + 0.01 * rng.standard_normal(gt_v.shape)
    keep = rng.uniform(size=len(gt_f)) > 0.1
    return rec_v, gt_f[keep], gt_v, gt_f


def test_cull_mesh_and_3d_metric_match_jax():
    from attentive_dfprior_tpu.tools import cull_mesh as JC
    from attentive_dfprior_tpu.tools import eval_recon as JE
    from attentive_dfprior_tpu.utils.synthetic import SyntheticScene as JScene
    from attentive_dfprior_tpu_torch.tools import cull_mesh as TC
    from attentive_dfprior_tpu_torch.tools import eval_recon as TE

    rec_v, rec_f, gt_v, gt_f = _two_meshes()
    poses = np.stack([JScene(arc_degrees=90.0).pose_at(s) for s in (0.0, 0.5, 1.0)])
    cam = dict(H=120, W=160, fx=120.0, fy=120.0, cx=79.5, cy=59.5)
    for a, b in zip(JC.cull_mesh(gt_v, gt_f, poses, **cam), TC.cull_mesh(gt_v, gt_f, poses, **cam)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TC.unseen_pointcloud(gt_v, gt_f, poses, n_samples=500, **cam),
                                  JC.unseen_pointcloud(gt_v, gt_f, poses, n_samples=500, **cam))
    ref = JE.calc_3d_metric(rec_v, rec_f, gt_v, gt_f, n_samples=20_000)
    got = TE.calc_3d_metric(rec_v, rec_f, gt_v, gt_f, n_samples=20_000)
    assert got == ref
    assert 0.0 < got["accuracy_cm"] < 10.0 and got["completion_ratio_pct"] > 50.0


def test_2d_metric_matches_jax(jax_native):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native rasterizer cannot be built here")
    from attentive_dfprior_tpu.tools import eval_recon as JE
    from attentive_dfprior_tpu_torch.tools import eval_recon as TE

    rec_v, rec_f, gt_v, gt_f = _two_meshes()
    kw = dict(n_imgs=4, H=64, W=64, focal=40.0, seed=1)
    ref = JE.calc_2d_metric(rec_v, rec_f, gt_v, gt_f, **kw)
    got = TE.calc_2d_metric(rec_v, rec_f, gt_v, gt_f, **kw)
    assert got["n_views"] == ref["n_views"] == 4
    # the JAX package's library is built with -march=native, which may
    # contract the rasterizer's products into FMAs
    np.testing.assert_allclose(got["depth_l1_cm"], ref["depth_l1_cm"], rtol=1e-4)


def test_rasterizer_rejects_faces_outside_the_vertices():
    verts = np.zeros((3, 3))
    with pytest.raises(ValueError, match="face index"):
        native.rasterize_depth(verts, np.array([[0, 1, 3]]), np.eye(4), 10.0, 10.0, 4.0, 4.0, 8, 8)
    with pytest.raises(ValueError, match="w2c"):
        native.rasterize_depth(verts, np.array([[0, 1, 2]]), np.eye(3), 10.0, 10.0, 4.0, 4.0, 8, 8)


# ---------------------------------------------------------------------------
# system side outputs and the builder CLI
# ---------------------------------------------------------------------------


def test_slam_side_outputs_and_get_mesh(tmp_path):
    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem
    from attentive_dfprior_tpu_torch.tsdf.builder import build_tsdf_volume
    from attentive_dfprior_tpu_torch.tsdf.fusion import fill_unobserved_volume

    torch.set_num_threads(1)
    cfg = tiny_room_cfg()
    cfg["mapping"].update(iters_first=4, iters=3, mesh_freq=2)
    cfg["meshing"]["resolution"] = 20
    cfg["tsdf"]["fill_unobserved_train"] = "free"
    slam = SLAMSystem(cfg, output=str(tmp_path), device="cpu")
    _, _, vol = build_tsdf_volume(
        cfg, space=int(cfg["tsdf"]["space"]), voxel_size=cfg["tsdf"]["voxel_size"], device="cpu"
    )
    observed = vol.observed_mask()
    assert observed.any() and not observed.all()
    np.testing.assert_array_equal(slam.tsdf_volume_track.numpy(), vol.device_volume().numpy())
    np.testing.assert_array_equal(slam.tsdf_volume.numpy(),
                                  fill_unobserved_volume(slam.tsdf_volume_track.numpy(), observed, "free"))
    np.testing.assert_array_equal(slam.tsdf_volume_mesh.numpy(), slam.tsdf_volume.numpy())
    assert slam.mapper.tsdf_volume is slam.tsdf_volume
    assert slam.tracker.tsdf_volume is slam.tsdf_volume_track
    slam.run(end_idx=3)
    names = sorted(os.listdir(tmp_path / "mesh"))
    assert names == ["00002_mesh.ply", "final_mesh.ply", "final_mesh_eval_rec.ply"]
    v, f, c = TPLY.read_ply(str(tmp_path / "mesh" / "final_mesh.ply"))
    assert len(f) > 0 and c is not None and np.isfinite(v).all()
    out = slam.get_mesh(str(tmp_path / "again.ply"))
    np.testing.assert_allclose(out[0], v, atol=1e-6)  # the PLY holds float32
    np.testing.assert_array_equal(out[1], f)


def test_tsdf_builder_cli_writes_a_prior_the_system_loads(tmp_path, monkeypatch):
    from attentive_dfprior_tpu_torch.slam.system import load_tsdf_volume
    from attentive_dfprior_tpu_torch.tsdf import builder

    room = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "Synthetic", "room.yaml")
    cfg_path = tmp_path / "tiny_room.yaml"
    cfg_path.write_text(f"inherit_from: {room}\ntsdf:\n  voxel_size: 0.16\n")
    out_dir = tmp_path / "synthetic_tsdf_volume"
    out = builder.main([str(cfg_path), "--output", str(out_dir), "--space", "20", "--device", "cpu"])
    data = np.load(out)
    assert data["tsdf"].ndim == 3 and data["observed"].any() and abs(float(data["voxel_size"]) - 0.16) < 1e-7
    _, f, _ = TPLY.read_ply(str(out_dir / "room_mesh.ply"))
    assert len(f) > 100
    cfg = tiny_room_cfg()
    cfg["tsdf"]["voxel_size"] = float(data["voxel_size"])
    monkeypatch.chdir(tmp_path)  # where SLAMSystem looks for <dataset>_tsdf_volume/
    vol, bnds, observed, source = load_tsdf_volume(cfg, device="cpu")
    assert os.path.abspath(source) == os.path.abspath(out)
    np.testing.assert_array_equal(vol.numpy(), data["tsdf"])
    np.testing.assert_array_equal(observed, data["observed"])
    np.testing.assert_array_equal(bnds, data["bounds"])
