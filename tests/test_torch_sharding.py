"""The port's ray-axis data parallelism, in one process, against the JAX
package's 8-device mesh (tests/conftest.py's virtual CPU devices).

The port's shard arithmetic runs with ``RayShards(size=8, ranks=0..7)`` and
no process group: every rank's part (its block of the ray axis, its render,
its local gradients) runs here and the parts are summed, which is what the
group's one all-reduce does across processes. Each case is held against
the unsharded port step and against the JAX package's step on the 8-device
mesh, on the same inputs (numpy, from a seed; the JAX draws replayed as
pixel indices):

  - ``sharded_mapping_step`` (one Adam step; it is the mapper's own
    ``mapping_step``, which ``mapping_stage`` runs every iteration);
  - ``mapping_stage`` with ``parallel.accum`` = 3;
  - a BA stage (window poses with the scene);
  - ``track_frame`` with the global median of the dynamic-pixel cut and the
    global best candidate.

Tolerances: losses rtol 1e-5 everywhere; parameters of the 8 ranks against
the unsharded port rtol 2e-4 / atol 1e-6 after one step
(tests/test_sharding.py:166-171) and, over the stages' 3-4 steps, the JAX
package's own dp-stage tolerance rtol 3e-4 / atol 5e-5
(tests/test_sharding.py:252-255): Adam's normalized step turns the
reassociated sum of a near-zero gradient into a visible move. Parameters
against the JAX package differ the same way with and without sharding
(the two packages' gradients part in float32 roundoff, and one element
with a gradient near zero may step the other way), so they are held as
the port's unsharded steps are (tests/test_torch_slam.py's
``assert_params_close``: mean drift within 2 % of the mean movement), with
at least 99 % of each leaf's elements at rtol 2e-4 / atol 1e-6. The
tracker's pose, 7 well-conditioned numbers, is held at rtol 2e-4 /
atol 1e-6 against both.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu.camera import Camera as JCamera
from attentive_dfprior_tpu.ops.adam import adam_init as j_adam_init
from attentive_dfprior_tpu.ops.pose import pose_tensor_from_matrix
from attentive_dfprior_tpu.parallel.sharding import make_mesh, ray_sharding, replicate, shard_rays
from attentive_dfprior_tpu.parallel.sharding import sharded_mapping_step as j_sharded_step
from attentive_dfprior_tpu.render.renderer import RenderConfig as JRenderConfig
from attentive_dfprior_tpu.slam import mapper as j_mapper
from attentive_dfprior_tpu.slam.tracker import track_frame as j_track_frame
from attentive_dfprior_tpu_torch.camera import Camera
from attentive_dfprior_tpu_torch.models.scene import params_from_numpy, params_to_numpy
from attentive_dfprior_tpu_torch.ops.adam import adam_init
from attentive_dfprior_tpu_torch.parallel import sharding as S
from attentive_dfprior_tpu_torch.render.renderer import RenderConfig
from attentive_dfprior_tpu_torch.slam.mapper import StageLRs, mapping_grads, mapping_stage
from attentive_dfprior_tpu_torch.slam.tracker import track_frame
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import __graft_entry__ as ge  # noqa: E402
from test_torch_slam import assert_params_close  # noqa: E402

torch.set_num_threads(1)
LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
STAGE_TOL = dict(rtol=3e-4, atol=5e-5)
EIGHT = S.RayShards(size=8, ranks=tuple(range(8)))
ONE = S.RayShards(size=1, ranks=(0,))
LRS = (5e-3, 5e-3, 5e-3, 5e-3, 5e-3)
CAM = dict(H=24, W=32, fx=24.0, fy=24.0, cx=15.5, cy=11.5)


@pytest.fixture(scope="module")
def scene():
    """The JAX package's tiny scene (``__graft_entry__._tiny_scene``) and
    the port's copy: the same leaves, the prior as an (X, Y, Z) volume."""
    jparams, jtsdf, jbnds, jbound, _ = ge._tiny_scene()
    vol = np.zeros((16, 16, 16), np.float32)
    vol[:, 8:, :] = 0.5
    vol[:, :8, :] = -0.5
    bound = np.asarray(jbound)
    return dict(
        jparams=jparams, jtsdf=jtsdf, jbnds=jbnds, jbound=jbound, np_params=jax.tree_util.tree_map(np.asarray, jparams),
        tsdf=torch.tensor(vol), tsdf_bnds=torch.tensor(bound), bound=torch.tensor(bound),
    )


def _assert_trees(got, ref, tol=PARAM_TOL):
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _assert_vs_jax(got, ref, init):
    """The port's parameters against the JAX package's (module docstring)."""
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.mean(np.isclose(a, b, **PARAM_TOL)) >= 0.99
    assert_params_close(got, ref, init)


def _rays(R, seed=5):
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    ro = np.asarray(jax.random.uniform(k1, (R, 3), minval=-0.3, maxval=0.3))
    d = np.asarray(jax.random.normal(k2, (R, 3)))
    rd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    gd = np.full((R,), 0.8, np.float32)
    gd[::7] = 0.65  # a batch-wide max the blocks do not all share
    gc = np.full((R, 3), 0.5, np.float32)
    inside = np.ones((R,), bool)
    inside[3::11] = False
    return ro, rd, gd, gc, inside


def _port_step(s, shards, arrays, grid_vjp="halo"):
    params = params_from_numpy(s["np_params"])
    for t in tree_leaves(params):
        t.requires_grad_(True)
    state = adam_init(params)
    loss = S.sharded_mapping_step(
        params, state, *(torch.tensor(a) for a in arrays), s["tsdf"], s["tsdf_bnds"], s["bound"],
        StageLRs(*LRS), "color", RenderConfig(N_samples=8, N_surface=4), (False, False), 0.2, shards, grid_vjp,
    )
    return float(loss), params_to_numpy(params)


def test_ray_block_rule():
    """Contiguous blocks in rank order that cover the batch; equal when the
    batch divides (``P('dp')``'s blocks), else the first n % size one ray
    longer; a batch smaller than the group raises."""
    for n, size in ((64, 8), (61, 8), (8, 8), (1000, 3), (5, 1)):
        blocks = [S.ray_block(n, r, size) for r in range(size)]
        assert blocks[0].start == 0 and blocks[-1].stop == n
        assert all(a.stop == b.start for a, b in zip(blocks, blocks[1:]))
        lens = [b.stop - b.start for b in blocks]
        assert lens == [n // size + (r < n % size) for r in range(size)]
    with pytest.raises(ValueError, match="cannot give"):
        S.ray_block(7, 0, 8)
    with pytest.raises(ValueError, match="not in"):
        S.ray_block(64, 8, 8)


def test_sharded_mapping_step_matches_unsharded_and_jax(scene):
    """One Adam step on 64 rays: the port's 8 ranks summed, the unsharded
    port step, and the JAX package's step on the 8-device mesh."""
    s = scene
    arrays = _rays(64)
    loss8, p8 = _port_step(s, EIGHT, arrays)
    loss1, p1 = _port_step(s, ONE, arrays)
    mesh = make_mesh(jax.devices()[:8])
    jargs = shard_rays(mesh, *(jnp.asarray(a) for a in arrays))
    jp, _, jloss = j_sharded_step(
        replicate(mesh, jax.tree_util.tree_map(jnp.copy, s["jparams"])), replicate(mesh, j_adam_init(s["jparams"])),
        *jargs, replicate(mesh, s["jtsdf"]), s["jbnds"], s["jbound"], j_mapper.StageLRs(*LRS), "color",
        JRenderConfig(N_samples=8, N_surface=4), (False, False), 0.2,
    )
    np.testing.assert_allclose(loss8, loss1, **LOSS_TOL)
    np.testing.assert_allclose(loss8, float(jloss), **LOSS_TOL)
    _assert_trees(p8, p1)
    _assert_vs_jax(p8, jax.device_get(jp), s["np_params"])
    moved = [np.abs(a - b).max() for a, b in zip(jax.tree_util.tree_leaves(p8), jax.tree_util.tree_leaves(s["np_params"]))]
    assert max(moved) > 1e-3  # the step did move the scene


def test_uneven_blocks_match_unsharded_and_jax(scene):
    """61 rays over 8 ranks (blocks of 8 and 7): the sum is still the whole
    batch's step; JAX's reference is its unsharded step (its mesh needs a
    divisible batch)."""
    s = scene
    arrays = _rays(61, seed=9)
    blocks = [S.ray_block(61, r, 8) for r in range(8)]
    assert [b.stop - b.start for b in blocks] == [8, 8, 8, 8, 8, 7, 7, 7]
    loss8, p8 = _port_step(s, EIGHT, arrays)
    loss1, p1 = _port_step(s, ONE, arrays)
    jp, _, jloss = j_sharded_step(
        jax.tree_util.tree_map(jnp.copy, s["jparams"]), j_adam_init(s["jparams"]), *(jnp.asarray(a) for a in arrays),
        s["jtsdf"], s["jbnds"], s["jbound"], j_mapper.StageLRs(*LRS), "color",
        JRenderConfig(N_samples=8, N_surface=4), (False, False), 0.2,
    )
    np.testing.assert_allclose(loss8, loss1, **LOSS_TOL)
    np.testing.assert_allclose(loss8, float(jloss), **LOSS_TOL)
    _assert_trees(p8, p1)
    _assert_vs_jax(p8, jax.device_get(jp), s["np_params"])


def test_rank_parts_sum_to_the_whole_gradient(scene):
    """Each rank's part alone (the mapper's ``mapping_grads`` with
    ``RayShards(size=8, ranks=(r,))`` and no group, what one process of a
    group computes before its all-reduce): the eight ranks' block losses
    and gradients summed equal the whole batch's, leaf by leaf."""
    s = scene
    arrays = [torch.tensor(a) for a in _rays(64, seed=11)]
    params = params_from_numpy(s["np_params"])
    for t in tree_leaves(params):
        t.requires_grad_(True)
    rcfg = RenderConfig(N_samples=8, N_surface=4)
    common = (s["tsdf"], s["tsdf_bnds"], s["bound"], "color", rcfg, 0.2)
    whole_l, whole_g = mapping_grads(params, *arrays, *common)
    parts = [mapping_grads(params, *arrays, *common, shards=S.RayShards(size=8, ranks=(r,))) for r in range(8)]
    np.testing.assert_allclose(float(sum(p[0] for p in parts)), float(whole_l), **LOSS_TOL)
    for i, g in enumerate(whole_g):
        if g is None:
            assert all(p[1][i] is None for p in parts)
            continue
        total = sum(p[1][i] for p in parts)
        np.testing.assert_allclose(total.numpy(), g.numpy(), rtol=1e-4, atol=1e-6 * float(g.abs().max()))


def _frames(F, seed):
    rng = np.random.default_rng(seed)
    colors = rng.uniform(0, 1, (F, CAM["H"], CAM["W"], 3)).astype(np.float32)
    depths = rng.uniform(0.4, 0.9, (F, CAM["H"], CAM["W"])).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.0, 0.3]
    return colors, depths, np.tile(c2w, (F, 1, 1))


def _stage_draws(keys, F, n):
    """The JAX mapping stage's pixel draws, (iters, F, n) flat indices."""
    return torch.tensor(np.stack([
        np.stack([np.asarray(jax.random.randint(fk, (n,), 0, CAM["H"] * CAM["W"])) for fk in jax.random.split(k, F)])
        for k in keys
    ]), dtype=torch.int64)


def _run_stages(s, F, n_iters, pixs, accum, ba, seed):
    """The JAX stage on the 8-device mesh and the port's stage unsharded
    and on 8 ranks, same draws. Returns {name: (params, losses)}."""
    colors, depths, c2ws = _frames(F, seed)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), n_iters)
    wf = np.zeros((n_iters,), np.float32)
    pose_t = np.stack([pose_tensor_from_matrix(c2ws[i]) for i in range(F)]).astype(np.float32)
    pose_mask = np.array([0.0] + [1.0] * (F - 1), np.float32)
    mesh = make_mesh(jax.devices()[:8])
    jp = jax.tree_util.tree_map(jnp.copy, s["jparams"])
    if ba:
        jp = {"scene": jp, "pose": jnp.asarray(pose_t)}
    jp, _, jl = j_mapper.mapping_stage(
        jp, j_adam_init(jp), jnp.asarray(colors), jnp.asarray(depths), jnp.asarray(c2ws), None, s["jtsdf"],
        s["jbnds"], s["jbound"], keys, jnp.asarray(wf), j_mapper.StageLRs(*LRS), "color", pixs,
        JCamera(**CAM), JRenderConfig(N_samples=8, N_surface=4), (False, False), 0.2, False,
        ray_sharding(mesh), None, accum, ba, jnp.asarray(pose_mask) if ba else None, jnp.float32(1e-3) if ba else 0.0,
    )
    out = {"jax8": (jax.tree_util.tree_map(np.asarray, jp), np.asarray(jl))}
    draws = _stage_draws(keys, F, pixs * accum)
    for name, shards in (("port1", None), ("port8", EIGHT)):
        params = params_from_numpy(s["np_params"])
        if ba:
            params = {"scene": params, "pose": torch.tensor(pose_t)}
        for t in tree_leaves(params):
            t.requires_grad_(True)
        losses = mapping_stage(
            params, adam_init(params), torch.tensor(colors), torch.tensor(depths), torch.tensor(c2ws), None,
            s["tsdf"], s["tsdf_bnds"], s["bound"], n_iters, list(wf), StageLRs(*LRS), "color", pixs,
            Camera(**CAM), RenderConfig(N_samples=8, N_surface=4), (False, False), 0.2, pixel_idx=draws,
            accum=accum, ba=ba, pose_mask=torch.tensor(pose_mask) if ba else None, ba_cam_lr=1e-3 if ba else 0.0,
            shards=shards,
        )
        out[name] = (params_to_numpy(params), losses.numpy())
    return out


def test_accum_stage_sharded_matches_unsharded_and_jax(scene):
    """``parallel.accum`` = 3 under dp: three iterations of a 2-frame window
    at 16 x 3 pixels a frame (96 rays, 12 a rank), loss scaled 1/3."""
    out = _run_stages(scene, F=2, n_iters=3, pixs=16, accum=3, ba=False, seed=3)
    for ref in ("port1", "jax8"):
        np.testing.assert_allclose(out["port8"][1], out[ref][1], **LOSS_TOL)
    _assert_trees(out["port8"][0], out["port1"][0], STAGE_TOL)
    _assert_vs_jax(out["port8"][0], out["jax8"][0], scene["np_params"])


def test_ba_stage_sharded_matches_unsharded_and_jax(scene):
    """mapping.BA under dp: the window poses' gradient rides the scene's
    bucket; the anchor stays, the other poses move."""
    out = _run_stages(scene, F=3, n_iters=4, pixs=16, accum=1, ba=True, seed=5)
    for ref in ("port1", "jax8"):
        np.testing.assert_allclose(out["port8"][1], out[ref][1], **LOSS_TOL)
    _assert_trees(out["port8"][0], out["port1"][0], STAGE_TOL)
    init = pose_tensor_from_matrix(_frames(3, 5)[2][0])
    _assert_vs_jax(out["port8"][0], out["jax8"][0], {"scene": scene["np_params"], "pose": np.tile(init, (3, 1))})
    pose8 = out["port8"][0]["pose"]
    np.testing.assert_array_equal(pose8[0], init)  # the anchor
    assert not np.allclose(pose8[1], init)


@pytest.mark.parametrize("handle_dynamic", [True, False])
def test_track_frame_sharded_matches_unsharded_and_jax(scene, handle_dynamic):
    """Pose-only optimization on 64 rays (8 a rank), 3 iterations from a
    perturbed pose: with the dynamic-pixel cut the median is every ray's
    (gathered), and the kept candidate follows the summed loss."""
    s = scene
    colors, depths, _ = _frames(1, 7)
    depths[0, :6, :] = 0.0  # rays without depth
    init = np.array([1.0, 0.01, -0.02, 0.0, 0.02, -0.01, 0.28], np.float32)
    key = jax.random.PRNGKey(13)
    n, iters, edge = 64, 3, 2
    args = (n, iters, edge, edge, handle_dynamic, True, 0.5, 1e-3, False)
    mesh = make_mesh(jax.devices()[:8])
    jb, jl, _, _ = j_track_frame(
        s["jparams"], jnp.asarray(init), jnp.asarray(colors[0]), jnp.asarray(depths[0]), s["jtsdf"], s["jbnds"],
        s["jbound"], key, JCamera(**CAM), JRenderConfig(N_samples=8, N_surface=4), *args, ray_sharding(mesh),
    )
    draws = torch.tensor(np.stack([
        np.asarray(jax.random.randint(k, (n,), 0, (CAM["H"] - 2 * edge) * (CAM["W"] - 2 * edge)))
        for k in jax.random.split(key, iters)
    ]), dtype=torch.int64)
    got = {}
    for name, shards in (("port1", None), ("port8", EIGHT)):
        b, l, _, _ = track_frame(
            params_from_numpy(s["np_params"]), torch.tensor(init), torch.tensor(colors[0]), torch.tensor(depths[0]),
            s["tsdf"], s["tsdf_bnds"], s["bound"], Camera(**CAM), RenderConfig(N_samples=8, N_surface=4), *args,
            pixel_idx=draws, shards=shards,
        )
        got[name] = (b.numpy(), l.numpy())
    for ref in (got["port1"], (np.asarray(jb), np.asarray(jl))):
        np.testing.assert_allclose(got["port8"][1], ref[1], **LOSS_TOL)
        np.testing.assert_allclose(got["port8"][0], ref[0], **PARAM_TOL)
    assert not np.allclose(got["port8"][0], init)


def test_track_median_is_the_whole_batchs(scene, monkeypatch):
    """The dynamic-pixel cut's median under dp is taken over every ray:
    ``masked_lower_median`` sees all 64 errors and their in-bound mask
    once per iteration, not each rank's 8."""
    from attentive_dfprior_tpu_torch.slam import tracker as T

    s = scene
    colors, depths, _ = _frames(1, 7)
    seen = []
    orig = T.masked_lower_median

    def spy(values, mask):
        seen.append((tuple(values.shape), int(mask.sum())))
        return orig(values, mask)

    monkeypatch.setattr(T, "masked_lower_median", spy)
    T.track_frame(
        params_from_numpy(s["np_params"]), torch.tensor([1.0, 0, 0, 0, 0, 0, 0.3]), torch.tensor(colors[0]),
        torch.tensor(depths[0]), s["tsdf"], s["tsdf_bnds"], s["bound"], Camera(**CAM),
        RenderConfig(N_samples=8, N_surface=4), 64, 2, 2, 2, True, True, 0.5, 1e-3,
        generator=torch.Generator().manual_seed(0), shards=EIGHT,
    )
    assert [v for v, _ in seen] == [(64,), (64,)]


def test_mesh_from_config_rules(monkeypatch):
    """None when off or below 2 ranks; ``n_devices`` above the world raises
    as in the JAX package; below the world raises too (one process per
    device: launch that many processes)."""
    assert S.mesh_from_config({}) is None
    assert S.mesh_from_config({"parallel": {"enable": False}}) is None
    assert S.mesh_from_config({"parallel": {"enable": True}}) is None  # no group: a world of one
    with pytest.raises(ValueError, match="only 1 processes"):
        S.mesh_from_config({"parallel": {"enable": True, "n_devices": 2}})
    monkeypatch.setattr(S.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(S.dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(S.dist, "get_rank", lambda group=None: 2)
    shards = S.mesh_from_config({"parallel": {"enable": True, "n_devices": -1}})
    assert shards.size == 4 and shards.ranks == (2,) and shards.group is S.dist.group.WORLD
    assert S.mesh_from_config({"parallel": {"enable": True, "n_devices": 4}}).size == 4
    with pytest.raises(ValueError, match="launch 2 processes"):
        S.mesh_from_config({"parallel": {"enable": True, "n_devices": 2}})
    with pytest.raises(ValueError, match="only 4 processes"):
        S.mesh_from_config({"parallel": {"enable": True, "n_devices": 8}})
