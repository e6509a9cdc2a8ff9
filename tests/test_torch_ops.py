"""The port's geometry, rendering, fusion and bookkeeping ops against the
JAX package, on the CPU.

Tolerances: pose math, rays and compositing rtol 1e-6 / atol 1e-6 (the same
float32 formulas; a few reductions sum in another order); rendered depth and
color rtol 1e-4 / atol 1e-5 (a whole MLP per sample); TSDF fusion exact
except where float32 roundoff moves a voxel's projection across a pixel
boundary (counted, at most 0.5 % of voxels; 0.2 % measured); host-side
numpy code exact.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu.camera import Camera as JCamera
from attentive_dfprior_tpu.models.decoders import init_df_decoders
from attentive_dfprior_tpu.ops import compositing as JC
from attentive_dfprior_tpu.ops import pose as JP
from attentive_dfprior_tpu.ops import rays as JR
from attentive_dfprior_tpu.ops.grid_sample import tsdf_to_rows
from attentive_dfprior_tpu.render import renderer as JRen
from attentive_dfprior_tpu.slam import mapper as JM
from attentive_dfprior_tpu.slam.tracker import masked_lower_median as j_median
from attentive_dfprior_tpu.tsdf.fusion import integrate_frame as j_integrate
from attentive_dfprior_tpu_torch.camera import Camera
from attentive_dfprior_tpu_torch.models.scene import params_from_numpy
from attentive_dfprior_tpu_torch.ops import compositing as TC
from attentive_dfprior_tpu_torch.ops import pose as TP
from attentive_dfprior_tpu_torch.ops import rays as TR
from attentive_dfprior_tpu_torch.render import renderer as TRen
from attentive_dfprior_tpu_torch.slam import mapper as TM
from attentive_dfprior_tpu_torch.slam.tracker import masked_lower_median
from attentive_dfprior_tpu_torch.tsdf.fusion import integrate_frame

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


def _pose(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    t = rng.uniform(-1, 1, 3)
    return np.concatenate([q, t]).astype(np.float32)


def test_pose_ops_match_jax():
    tens = np.stack([_pose(i) for i in range(5)]) * np.float32(1.1)  # non-unit quaternions
    np.testing.assert_allclose(TP.quat_to_rotation(torch.tensor(tens[:, :4])).numpy(),
                               np.asarray(JP.quat_to_rotation(jnp.asarray(tens[:, :4]))), **TOL)
    m = TP.pose_matrix_from_tensor(torch.tensor(tens))
    np.testing.assert_allclose(m.numpy(), np.asarray(JP.pose_matrix_from_tensor(jnp.asarray(tens))), **TOL)
    np.testing.assert_allclose(TP.homogenize(m[0]).numpy(), np.asarray(JP.homogenize(jnp.asarray(m[0].numpy()))))
    c2w = np.asarray(JP.homogenize(JP.pose_matrix_from_tensor(jnp.asarray(_pose(7)))))
    np.testing.assert_array_equal(TP.pose_tensor_from_matrix(c2w), JP.pose_tensor_from_matrix(c2w))
    new = c2w.copy()
    new[:3, 3] += [0.05, -0.02, 0.01]
    new[:3, :3] = np.asarray(JP.quat_to_rotation(jnp.asarray([0.99, 0.05, 0.02, 0.0]))) @ c2w[:3, :3]
    np.testing.assert_array_equal(TP.clamp_pose_update(c2w, new, 0.02, np.deg2rad(1.0)),
                                  JP.clamp_pose_update(c2w, new, 0.02, np.deg2rad(1.0)))


def test_rays_and_sampling_match_jax():
    rng = np.random.default_rng(1)
    H, W = 12, 16
    depth = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    color = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    c2w = np.asarray(JP.pose_matrix_from_tensor(jnp.asarray(_pose(2))))
    key = jax.random.PRNGKey(4)
    jo, jd, jgd, jgc = JR.get_samples(key, 2, H - 2, 3, W - 3, 50, 14.0, 14.0, 7.5, 5.5,
                                      jnp.asarray(c2w), jnp.asarray(depth), jnp.asarray(color))
    idx = torch.tensor(np.asarray(jax.random.randint(key, (50,), 0, (H - 4) * (W - 6))))
    to, td, tgd, tgc = TR.get_samples(2, H - 2, 3, W - 3, 50, 14.0, 14.0, 7.5, 5.5, torch.tensor(c2w),
                                      torch.tensor(depth), torch.tensor(color), pixel_idx=idx)
    for a, b in ((to, jo), (td, jd), (tgd, jgd), (tgc, jgc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    fo, fd = TR.get_rays_full_image(H, W, 14.0, 14.0, 7.5, 5.5, torch.tensor(c2w))
    jfo, jfd = JR.get_rays_full_image(H, W, 14.0, 14.0, 7.5, 5.5, jnp.asarray(c2w))
    np.testing.assert_allclose(fd.numpy(), np.asarray(jfd), **TOL)
    np.testing.assert_allclose(fo.numpy(), np.asarray(jfo), **TOL)
    bound = np.array([[-2.0, 2.5], [-1.5, 1.7], [-2.2, 2.0]], np.float32)
    np.testing.assert_allclose(TR.ray_bound_intersection(to, td, torch.tensor(bound)).numpy(),
                               np.asarray(JR.ray_bound_intersection(jo, jd, jnp.asarray(bound))), **TOL)


def test_batched_rays_equal_per_frame_rays():
    """(F, 3, 4) poses with (F, N) pixels: the batched form of the JAX
    mapper's per-frame vmap."""
    rng = np.random.default_rng(2)
    c2ws = torch.stack([TP.pose_matrix_from_tensor(torch.tensor(_pose(i))) for i in range(3)])
    i = torch.tensor(rng.uniform(0, 16, (3, 20)).astype(np.float32))
    j = torch.tensor(rng.uniform(0, 12, (3, 20)).astype(np.float32))
    bo, bd = TR.get_rays_from_uv(i, j, c2ws, 14.0, 14.0, 7.5, 5.5)
    for f in range(3):
        o, d = TR.get_rays_from_uv(i[f], j[f], c2ws[f], 14.0, 14.0, 7.5, 5.5)
        np.testing.assert_array_equal(bo[f].numpy(), o.numpy())
        np.testing.assert_array_equal(bd[f].numpy(), d.numpy())


@pytest.mark.parametrize("occupancy", [True, False])
def test_raw2outputs_matches_jax(occupancy):
    rng = np.random.default_rng(3)
    raw = rng.standard_normal((40, 12, 4)).astype(np.float32)
    z = np.sort(rng.uniform(0.1, 4.0, (40, 12)), axis=-1).astype(np.float32)
    rd = rng.standard_normal((40, 3)).astype(np.float32)
    ref = JC.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd), occupancy)
    got = TC.raw2outputs(torch.tensor(raw), torch.tensor(z), torch.tensor(rd), occupancy)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def _render_setup(seed=5):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, init_df_decoders(jax.random.PRNGKey(seed)))
    params["grid_low"] = (rng.standard_normal((14, 11, 14, 32)) * 0.1).astype(np.float32)
    params["grid_high"] = (rng.standard_normal((28, 22, 28, 32)) * 0.1).astype(np.float32)
    params["grid_color"] = (rng.standard_normal((28, 22, 28, 32)) * 0.1).astype(np.float32)
    bound = np.array([[-2.2, 2.28], [-1.7, 1.82], [-2.2, 2.28]], np.float32)
    tsdf = np.clip(rng.normal(0.3, 0.6, (20, 16, 20)), -1, 1).astype(np.float32)
    return params, bound, tsdf


@pytest.mark.parametrize("no_gt_depth", [False, True])
def test_make_z_vals_matches_jax(no_gt_depth):
    rng = np.random.default_rng(6)
    ro = np.tile(np.array([[0.3, -0.2, 0.5]], np.float32), (30, 1))
    rd = rng.standard_normal((30, 3)).astype(np.float32)
    gd = rng.uniform(0.0, 3.0, 30).astype(np.float32)
    gd[:5] = 0.0
    bound = np.array([[-2.2, 2.28], [-1.7, 1.82], [-2.2, 2.28]], np.float32)
    ref = JRen.make_z_vals(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(gd), jnp.asarray(bound),
                           JRen.RenderConfig(), no_gt_depth=no_gt_depth)
    got = TRen.make_z_vals(torch.tensor(ro), torch.tensor(rd), torch.tensor(gd), torch.tensor(bound),
                           TRen.RenderConfig(), no_gt_depth=no_gt_depth)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_render_rays_and_pose_gradient_match_jax():
    """The tracker's chain: rays from a differentiable pose, rendered in the
    color stage; values and the 7-DoF pose gradient."""
    params, bound, tsdf = _render_setup()
    cam_t = np.array([0.9, 0.1, 0.3, -0.2, 0.4, -0.3, 0.6], np.float32)
    rng = np.random.default_rng(7)
    i = rng.uniform(0, 32, 40).astype(np.float32)
    j = rng.uniform(0, 24, 40).astype(np.float32)
    gd = rng.uniform(0.5, 2.5, 40).astype(np.float32)

    def jfn(ct):
        o, d = JR.get_rays_from_uv(jnp.asarray(i), jnp.asarray(j), JP.pose_matrix_from_tensor(ct), 24.0, 24.0, 15.5, 11.5)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        dep, var, col, _ = JRen.render_rays(jp, o, d, jnp.asarray(gd), tsdf_to_rows(tsdf), jnp.asarray(bound),
                                            jnp.asarray(bound), "color", JRen.RenderConfig())
        return jnp.sum(dep) + jnp.sum(col) + 0.1 * jnp.sum(var), (dep, col)

    (_, (jdep, jcol)), jg = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(cam_t))
    ct = torch.tensor(cam_t, requires_grad=True)
    o, d = TR.get_rays_from_uv(torch.tensor(i), torch.tensor(j), TP.pose_matrix_from_tensor(ct), 24.0, 24.0, 15.5, 11.5)
    tp = params_from_numpy(params)
    dep, var, col, _ = TRen.render_rays(tp, o, d, torch.tensor(gd), torch.tensor(tsdf), torch.tensor(bound),
                                        torch.tensor(bound), "color", TRen.RenderConfig())
    (dep.sum() + col.sum() + 0.1 * var.sum()).backward()
    np.testing.assert_allclose(dep.detach().numpy(), np.asarray(jdep), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(col.detach().numpy(), np.asarray(jcol), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(jg), rtol=1e-3, atol=1e-4 * float(np.abs(jg).max()))


def test_renderer_render_img_matches_jax():
    params, bound, tsdf = _render_setup(8)
    cam = dict(H=10, W=14, fx=12.0, fy=12.0, cx=6.5, cy=4.5)
    c2w = np.asarray(JP.homogenize(JP.pose_matrix_from_tensor(jnp.asarray(
        np.array([1.0, 0.0, 0.0, 0.0, 0.2, -0.1, 0.4], np.float32)))))
    depth = np.random.default_rng(9).uniform(0.5, 2.0, (10, 14)).astype(np.float32)
    jr = JRen.Renderer(JRen.RenderConfig(), bound, bound, JCamera(**cam), ray_batch_size=64, use_fused=False)
    ref = jr.render_img(jax.tree_util.tree_map(jnp.asarray, params), c2w, tsdf_to_rows(tsdf), gt_depth=depth)
    tr = TRen.Renderer(TRen.RenderConfig(), bound, bound, Camera(**cam), torch.device("cpu"), ray_batch_size=64)
    assert tr.use_fused is False  # the CPU takes the plain decoder path
    got = tr.render_img(params_from_numpy(params), c2w, torch.tensor(tsdf), gt_depth=depth)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
    # importance resampling renders too (tests/test_torch_importance.py
    # holds it to the JAX package in full)
    ro, rd, gd = np.zeros((2, 3), np.float32), np.ones((2, 3), np.float32), np.ones(2, np.float32)
    ref4 = JRen.render_rays(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(ro), jnp.asarray(rd),
                            jnp.asarray(gd), tsdf_to_rows(tsdf), jnp.asarray(bound), jnp.asarray(bound), "color",
                            JRen.RenderConfig(N_importance=4))
    got4 = TRen.render_rays(params_from_numpy(params), torch.tensor(ro), torch.tensor(rd), torch.tensor(gd),
                            torch.tensor(tsdf), torch.tensor(bound), torch.tensor(bound), "color",
                            TRen.RenderConfig(N_importance=4))
    for a, b in zip(got4[:3], ref4[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_renderer_eval_points_matches_jax():
    """The chunked point query, including points outside the bound (the
    occ = 100 wall)."""
    params, bound, tsdf = _render_setup(4)
    pts = np.random.default_rng(12).uniform(-2.6, 2.6, (300, 3)).astype(np.float32)
    cam = Camera(H=10, W=14, fx=12.0, fy=12.0, cx=6.5, cy=4.5)
    jr = JRen.Renderer(JRen.RenderConfig(), bound, bound, cam, use_fused=False)
    ref = jr.eval_points(jax.tree_util.tree_map(jnp.asarray, params), pts, tsdf_to_rows(tsdf))
    tr = TRen.Renderer(TRen.RenderConfig(), bound, bound, cam, torch.device("cpu"))
    got = tr.eval_points(params_from_numpy(params), pts, torch.tensor(tsdf))
    assert (got[:, 3] == 100.0).any()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_masked_lower_median_matches_jax():
    rng = np.random.default_rng(10)
    for n_true in (0, 1, 6, 7):
        v = rng.standard_normal(12).astype(np.float32)
        m = np.zeros(12, bool)
        m[rng.permutation(12)[:n_true]] = True
        ref = float(j_median(jnp.asarray(v), jnp.asarray(m)))
        got = float(masked_lower_median(torch.tensor(v), torch.tensor(m)))
        assert got == ref


def test_integrate_frame_matches_jax():
    rng = np.random.default_rng(11)
    X, Y, Z = 24, 20, 22
    depth = rng.uniform(0.5, 2.5, (18, 24)).astype(np.float32)
    depth[:3] = 0.0
    color = rng.uniform(0, 255, (18, 24, 3)).astype(np.float32)
    intr = np.array([[20.0, 0, 11.5], [0, 20.0, 8.5], [0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.1, -0.2, 1.2]
    origin = np.array([-1.0, -1.0, -0.5], np.float32)
    jt = jnp.full((X, Y, Z), -1.0)
    jw = jnp.zeros((X, Y, Z))
    jc = jnp.zeros((X, Y, Z, 3))
    tt = torch.full((X, Y, Z), -1.0)
    tw = torch.zeros((X, Y, Z))
    tc = torch.zeros((X, Y, Z, 3))
    for k in range(2):
        w = w2c.copy()
        w[0, 3] += 0.05 * k
        jt, jw, jc = j_integrate(jt, jw, jc, jnp.asarray(depth), jnp.asarray(color), jnp.asarray(intr),
                                 jnp.asarray(w), jnp.asarray(origin), 0.08, 0.4)
        integrate_frame(tt, tw, tc, torch.tensor(depth), torch.tensor(color), torch.tensor(intr),
                        torch.tensor(w), torch.tensor(origin), 0.08, 0.4)
    # a voxel whose projection lands within float32 roundoff of a pixel
    # boundary may round to the neighbouring pixel in one package
    assert (tw.numpy() != np.asarray(jw)).mean() <= 5e-3
    assert (np.abs(tt.numpy() - np.asarray(jt)) > 1e-6).mean() <= 5e-3
    assert (np.asarray(jw) > 0).mean() > 0.05  # the frames did touch the volume


def test_frustum_mask_and_lr_tree_match_jax():
    cam = dict(H=24, W=32, fx=24.0, fy=24.0, cx=15.5, cy=11.5)
    rng = np.random.default_rng(12)
    depth = rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32)
    depth[:4, :4] = 0.0
    c2w = np.asarray(JP.homogenize(JP.pose_matrix_from_tensor(jnp.asarray(_pose(3)))))
    bound = np.array([[-2.2, 2.28], [-1.7, 1.82], [-2.2, 2.28]])
    np.testing.assert_array_equal(
        TM.get_frustum_mask(c2w, (14, 11, 14), bound, depth, Camera(**cam)),
        JM.get_frustum_mask(c2w, (14, 11, 14), bound, depth, JCamera(**cam)),
    )
    params = jax.tree_util.tree_map(np.asarray, init_df_decoders(jax.random.PRNGKey(0)))
    lrs = (0.1, 0.2, 0.3, 0.4, 0.5)
    from attentive_dfprior_tpu.models.scene import SceneConfig

    ref = JM.build_lr_tree(params, JM.StageLRs(*lrs), SceneConfig(bound, 32, 0.32, 0.16, 0.16, fix_high=True))
    got = TM.build_lr_tree(params, TM.StageLRs(*lrs), fix_high=True, fix_color=False)
    assert jax.tree_util.tree_leaves(ref) == jax.tree_util.tree_leaves(got)


def test_checkpoint_written_by_jax_loads_into_port(tmp_path):
    from attentive_dfprior_tpu.models.scene import SceneConfig as JSceneConfig
    from attentive_dfprior_tpu.models.scene import init_scene as j_init_scene
    from attentive_dfprior_tpu.utils.logger import Logger as JLogger
    from attentive_dfprior_tpu_torch.models.scene import SceneConfig, init_scene
    from attentive_dfprior_tpu_torch.utils.logger import latest_checkpoint, load_checkpoint
    from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

    b = np.array([[-2.2, 2.28], [-1.7, 1.82], [-2.2, 2.28]])
    jparams = j_init_scene(jax.random.PRNGKey(1), JSceneConfig(b, 32, 0.32, 0.16, 0.16))
    est = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    JLogger(str(tmp_path), verbose=False).log(2, jparams, est, est, [0], est[:1], keyframe_gt_c2w=est[:1],
                                              selected_keyframes={0: [{"est_c2w": est[0]}]})
    ckpt = latest_checkpoint(str(tmp_path))
    template = init_scene(torch.Generator().manual_seed(0), SceneConfig(b, 32, 0.32, 0.16, 0.16))
    params, meta = load_checkpoint(ckpt, template)
    assert meta["idx"] == 2 and list(meta["selected_keyframes"]) == [0]
    for a, t in zip(jax.tree_util.tree_leaves(jparams), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), t.numpy())


def test_entry_points_refuse_missing_cuda_and_unported_modes(tmp_path):
    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem
    from attentive_dfprior_tpu_torch.utils.device import resolve_device
    from test_torch_slam import tiny_room_cfg

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    cfg = tiny_room_cfg()
    # the async modes construct (tests/test_torch_async.py runs them); an
    # unknown sync_method and sharding raise, before any data is read
    for sync in ("loose", "free"):
        slam = SLAMSystem(dict(cfg, sync_method=sync), output=str(tmp_path / sync), device="cpu")
        assert slam.sync_method == sync and slam.device.type == "cpu"
    with pytest.raises(ValueError, match="sync_method"):
        SLAMSystem(dict(cfg, sync_method="eager"), output=str(tmp_path), device="cpu")
    # parallel.enable with no process group (fewer than 2 ranks) constructs
    # and takes the single-device path, as the JAX mesh_from_config returns
    # None below 2 devices
    slam = SLAMSystem(dict(cfg, parallel={"enable": True}), output=str(tmp_path / "dp1"), device="cpu")
    assert slam.shards is None and slam.mapper.shards is None and slam.tracker.shards is None
    assert slam.is_rank0


@pytest.mark.parametrize("case", ["split", "loose_on_2_ranks", "free_on_2_ranks"])
def test_async_agents_under_dp_raise(tmp_path, monkeypatch, case):
    """The async agents across ranks refuse a world that cannot hold them:
    ``parallel.split`` with more ranks than the world has raises the JAX
    ``split_meshes_from_config``'s error, and ``loose`` / ``free`` on a dp
    group of 2 ranks with no process group behind it (a 2-rank group stands
    in for ``mesh_from_config``'s, no sockets needed) raise, since each
    agent needs a group of its own. The runs themselves are
    tests/test_torch_async_dp.py's and tests/test_torch_split.py's."""
    from attentive_dfprior_tpu_torch.parallel.sharding import RayShards
    from attentive_dfprior_tpu_torch.slam import system as sysmod
    from test_torch_slam import tiny_room_cfg

    cfg = tiny_room_cfg()
    if case == "split":
        cfg = dict(cfg, sync_method="loose", parallel={"enable": True, "split": {"map": 1, "track": 1}})
    else:
        monkeypatch.setattr(sysmod, "mesh_from_config", lambda c: RayShards(size=2, ranks=(0,)))
        cfg = dict(cfg, sync_method=case.split("_")[0], parallel={"enable": True})
    match = "exceeds 1 devices" if case == "split" else "needs the process group"
    with pytest.raises(ValueError, match=match):
        sysmod.SLAMSystem(cfg, output=str(tmp_path), device="cpu")
