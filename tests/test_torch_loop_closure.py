"""The port's loop closure against the JAX package's, on the CPU.

``propagate_corrections`` and the revisit scorer must equal the JAX
functions exactly (host numpy in both). The re-localizations
(``_relocalize``, ``maybe_relax`` on a 3-keyframe store, ``final_refine``
over 3 frames) replay the JAX pixel draws and are held to the tolerances of
``tests/test_torch_slam.py``: losses rtol 1e-4, poses within a tenth of
one Adam step (0.1 x lr). Propagated trajectory entries must follow the
port's own keyframe corrections within 1e-5, and frame 0 never moves.
Then the system: ``tracking.gt_camera`` turns loop closure off, and a
7-frame run with it on logs one final refine and writes a checkpoint the
JAX package loads.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu.camera import Camera as JCamera
from attentive_dfprior_tpu.ops.grid_sample import tsdf_to_rows
from attentive_dfprior_tpu.slam.keyframes import KeyframeStore as JKeyframeStore
from attentive_dfprior_tpu.slam.loop_closure import LoopCloser as JLoopCloser
from attentive_dfprior_tpu.slam.loop_closure import propagate_corrections as j_propagate
from attentive_dfprior_tpu.slam.tracker import Tracker as JTracker
from attentive_dfprior_tpu.utils.datasets import get_dataset as j_get_dataset
from attentive_dfprior_tpu_torch.camera import Camera
from attentive_dfprior_tpu_torch.models.scene import params_from_numpy
from attentive_dfprior_tpu_torch.slam.keyframes import KeyframeStore
from attentive_dfprior_tpu_torch.slam.loop_closure import LoopCloser, propagate_corrections
from attentive_dfprior_tpu_torch.slam.tracker import Tracker
from test_torch_slam import setup, tiny_room_cfg  # noqa: F401 (setup is a fixture)

LR = 0.01  # room_tracking.yaml's loop_closure.lr


def _pose(tx=0.0, ty=0.0, tz=0.0, yaw=0.0):
    c, s = np.cos(yaw), np.sin(yaw)
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    p[:3, 3] = [tx, ty, tz]
    return p


def _random_pose(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    p = np.eye(4)
    p[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                 [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                 [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
    p[:3, 3] = rng.normal(size=3)
    return p.astype(np.float32)


def _propagate_cases():
    """The three cases of tests/test_loop_closure.py, then random poses."""
    traj = np.stack([_pose(tx=0.1 * t) for t in range(10)])
    kf = np.array([0, 4, 8])
    new = traj[kf].copy()
    new[1] = _pose(tx=0.45)
    new[2] = _pose(tx=0.78)
    yield traj, kf, traj[kf].copy(), new, 9
    new = traj[kf].copy()
    new[1, 0, 3] += 0.07
    yield traj, kf, traj[kf].copy(), new, 9
    traj6 = np.stack([_pose(tx=0.1 * t) for t in range(6)])
    kf6 = np.array([0, 3])
    new = traj6[kf6].copy()
    new[1] = (_pose(yaw=0.1) @ new[1].astype(np.float64)).astype(np.float32)
    yield traj6, kf6, traj6[kf6].copy(), new, 5
    rng = np.random.default_rng(5)
    traj = np.stack([_random_pose(rng) for _ in range(15)])
    kf = np.array([0, 3, 7, 12])
    yield traj, kf, traj[kf].copy(), np.stack([_random_pose(rng) for _ in kf]), 13


@pytest.mark.parametrize("case", range(4))
def test_propagate_corrections_equals_jax(case):
    traj, kf, old, new, idx = list(_propagate_cases())[case]
    port, ref = traj.copy(), traj.copy()
    propagate_corrections(port, kf, old, new, idx)
    j_propagate(ref, kf, old, new, idx)
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port[0], traj[0])


def test_detect_revisit_equals_jax():
    """Same store, depth and poses: the same (slot, score) or None, over a
    sequence of calls that advance both scorers' generators."""
    jcam = JCamera(H=60, W=80, fx=60.0, fy=60.0, cx=39.5, cy=29.5)
    cam = Camera(H=60, W=80, fx=60.0, fy=60.0, cx=39.5, cy=29.5)
    rng = np.random.default_rng(0)
    depth = rng.uniform(1.0, 3.0, (60, 80)).astype(np.float32)
    color = np.zeros((60, 80, 3), np.float32)
    jk, pk = JKeyframeStore(4, 60, 80), KeyframeStore(4, 60, 80, torch.device("cpu"))
    for f, pose in ((0, _pose()), (5, _pose(tx=0.05, yaw=0.02)), (12, _pose(tz=0.1))):
        jk.add(f, color, depth, pose, pose)
        pk.add(f, color, depth, pose, pose)
    cfg = {"loop_closure": {"enable": True, "min_gap": 10, "overlap_gate": 0.1}, "tracking": {}}
    bnd = np.zeros((3, 2), np.float32)
    jl = JLoopCloser(cfg, None, jk, jcam, None, bnd, None, bnd)
    pl = LoopCloser(cfg, None, pk, cam, None, bnd, None, bnd)
    hits = []
    for idx, pose in ((8, _pose()), (20, _pose()), (20, _pose(tx=0.03)), (30, _pose(tx=50.0)), (25, _pose(yaw=0.05))):
        hit = pl.detect_revisit(idx, depth, pose)
        assert hit == jl.detect_revisit(idx, depth, pose)
        hits.append(hit)
    assert hits[0] is None and hits[1] is not None and hits[3] is None


@pytest.fixture(scope="module")
def lc_setup(setup):  # noqa: F811 (the fixture imported above)
    """Both packages' trackers and five tiny frames; loop closure fires on
    any revisit (the 24x32 camera lies inside the scorer's 20 px margin,
    so every score is 0 and the gate is 0), 4 iterations at lr 0.01."""
    s = setup
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in s["cfg"].items()}
    cfg["loop_closure"] = dict(cfg["loop_closure"], enable=True, final_refine=True, every=1, min_gap=1,
                               overlap_gate=0.0, kf_iters=None, refine_iters=None, lr=LR)
    ds = j_get_dataset(s["jcfg"])
    frames = [ds[i] for i in range(5)]
    bound = np.asarray(s["scfg"].bound, np.float32)
    jt = JTracker(cfg, s["jcam"], s["jrcfg"], bound, tsdf_to_rows(s["vol"]), s["tsdf_bnds"])
    pt = Tracker(cfg, s["cam"], s["rcfg"], bound, torch.tensor(s["vol"]), s["tsdf_bnds"], torch.device("cpu"))
    return dict(s, lc_cfg=cfg, lc_frames=frames, bound=bound, jtracker=jt, ptracker=pt,
                jparams=jax.tree_util.tree_map(jnp.asarray, s["params0"]))


def _draws(key, n_iters, s):
    """The JAX tracker's pixel draws for one key, (n_iters, pixels)."""
    t = s["lc_cfg"]["tracking"]
    H, W, e = s["cam"].H, s["cam"].W, t["ignore_edge_W"]
    return torch.tensor(np.stack([
        np.asarray(jax.random.randint(k, (t["pixels"],), 0, (H - 2 * e) * (W - 2 * e)))
        for k in jax.random.split(key, n_iters)
    ]), dtype=torch.int64)


def _closers(s, jk=None, pk=None):
    jlog, plog = [], []
    jl = JLoopCloser(s["lc_cfg"], s["jtracker"], jk, s["jcam"], s["jrcfg"], s["bound"],
                     tsdf_to_rows(s["vol"]), s["tsdf_bnds"], log_fn=jlog.append)
    pl = LoopCloser(s["lc_cfg"], s["ptracker"], pk, s["cam"], s["rcfg"], s["bound"],
                    torch.tensor(s["vol"]), s["tsdf_bnds"], log_fn=plog.append)
    # record every re-localization's losses
    jloss, ploss = [], []
    j_orig, p_orig = jl._relocalize, pl._relocalize

    def j_rec(*a, **k):
        out = j_orig(*a, **k)
        jloss.append(np.asarray(out[1]))
        return out

    def p_rec(*a, **k):
        out = p_orig(*a, **k)
        ploss.append(out[1].numpy())
        return out

    jl._relocalize, pl._relocalize = j_rec, p_rec
    return jl, pl, (jlog, plog), (jloss, ploss)


def _perturbed(frames):
    """GT poses with every frame but 0 moved a few cm."""
    rng = np.random.default_rng(1)
    est = np.stack([f[3] for f in frames]).copy()
    est[1:, :3, 3] += rng.uniform(-0.02, 0.02, (len(frames) - 1, 3)).astype(np.float32)
    return est


def test_relocalize_matches_jax(lc_setup):
    s = lc_setup
    jl, pl, _, _ = _closers(s)
    _, color, depth, gt = s["lc_frames"][1]
    init = gt.copy()
    init[:3, 3] += np.array([0.02, -0.01, 0.015], np.float32)
    key = jax.random.PRNGKey(21)
    n = s["lc_cfg"]["tracking"]["iters"]
    j_c2w, j_losses = jl._relocalize(s["jparams"], color, depth, init, key, n)
    p_c2w, p_losses = pl._relocalize(params_from_numpy(s["params0"]), color, depth, init, n,
                                     pixel_idx=_draws(key, n, s))
    np.testing.assert_allclose(p_losses.numpy(), np.asarray(j_losses), rtol=1e-4)
    np.testing.assert_allclose(p_c2w, j_c2w, atol=0.1 * LR)
    assert p_c2w.dtype == np.float32 and not np.allclose(p_c2w, init)


def test_maybe_relax_matches_jax(lc_setup):
    """Keyframes at frames 0, 2, 4 with perturbed poses, revisit at frame 4:
    slots 1 and 2 are re-localized and clamped, frames 1 and 3 take the
    correction of their nearest keyframe, frame 0 stays."""
    s = lc_setup
    frames = s["lc_frames"]
    est0 = _perturbed(frames)
    H, W = s["cam"].H, s["cam"].W
    jk, pk = JKeyframeStore(4, H, W), KeyframeStore(4, H, W, torch.device("cpu"))
    for f in (0, 2, 4):
        jk.add(f, frames[f][1], frames[f][2], est0[f], frames[f][3])
        pk.add(f, frames[f][1], frames[f][2], est0[f], frames[f][3])
    jl, pl, (jlog, plog), (jloss, ploss) = _closers(s, jk, pk)
    n = s["lc_cfg"]["tracking"]["iters"]
    key = jax.random.PRNGKey(5)
    draws, k = {}, key
    for slot in (1, 2):  # slot 0 holds frame 0
        k, sub = jax.random.split(k)
        draws[slot] = _draws(sub, n, s)
    j_est, p_est = est0.copy(), est0.copy()
    jl.maybe_relax(4, frames[4][2], est0[4], j_est, s["jparams"], key)
    assert pl.maybe_relax(4, frames[4][2], est0[4], p_est, params_from_numpy(s["params0"]), pixel_idx=draws)
    assert len(ploss) == len(jloss) == 2
    for a, b in zip(ploss, jloss):
        np.testing.assert_allclose(a, b, rtol=1e-4)
    np.testing.assert_allclose(pk.poses_np(), jk.poses_np(), atol=0.1 * LR)
    np.testing.assert_array_equal(pk.poses_np()[0], est0[0])
    # the trajectory follows the port's own keyframe corrections
    expect = est0.copy()
    j_propagate(expect, np.array([0, 2, 4]), est0[[0, 2, 4]], pk.poses_np(), 4)
    np.testing.assert_allclose(p_est, expect, atol=1e-5)
    np.testing.assert_allclose(p_est, j_est, atol=0.1 * LR)
    np.testing.assert_array_equal(p_est[0], est0[0])
    assert not np.allclose(p_est[1:], est0[1:])
    assert [r["event"] for r in plog] == [r["event"] for r in jlog] == ["loop_relax"]
    assert set(plog[0]) == set(jlog[0])
    assert {k: plog[0][k] for k in ("idx", "revisit_slot", "revisit_score")} == \
        {k: jlog[0][k] for k in ("idx", "revisit_slot", "revisit_score")}
    # the gate: `every` frames must pass before the next relaxation
    pl.every = 3
    assert not pl.maybe_relax(5, frames[4][2], est0[4], p_est.copy(), params_from_numpy(s["params0"]))


def test_final_refine_matches_jax(lc_setup):
    s = lc_setup
    frames = s["lc_frames"][:3]
    est0 = _perturbed(frames)
    jl, pl, (jlog, plog), (jloss, ploss) = _closers(s)
    n = s["lc_cfg"]["tracking"]["iters"]
    key = jax.random.PRNGKey(9)
    draws, k = {}, key
    for t in (1, 2):
        k, sub = jax.random.split(k)
        draws[t] = _draws(sub, n, s)
    j_est, p_est = est0.copy(), est0.copy()
    jl.final_refine(frames, j_est, s["jparams"], key, 0, 3)
    assert pl.final_refine(frames, p_est, params_from_numpy(s["params0"]), 0, 3, pixel_idx=draws)
    for a, b in zip(ploss, jloss):
        np.testing.assert_allclose(a, b, rtol=1e-4)
    np.testing.assert_allclose(p_est, j_est, atol=0.1 * LR)
    np.testing.assert_array_equal(p_est[0], est0[0])
    assert not np.allclose(p_est[1:], est0[1:])
    assert [r["event"] for r in plog] == [r["event"] for r in jlog] == ["loop_final_refine"]
    assert set(plog[0]) == set(jlog[0]) and plog[0]["frames"] == jlog[0]["frames"] == 2


def test_gt_camera_turns_loop_closure_off(tmp_path):
    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem

    cfg = tiny_room_cfg()
    cfg["loop_closure"].update(enable=True, final_refine=True)
    cfg["tracking"]["gt_camera"] = True
    slam = SLAMSystem(cfg, output=str(tmp_path), device="cpu")
    assert not slam.loop_closer.enable and not slam.loop_closer.final_refine_on
    cfg["tracking"]["gt_camera"] = False
    slam = SLAMSystem(cfg, output=str(tmp_path), device="cpu")
    assert slam.loop_closer.enable and slam.loop_closer.final_refine_on


def test_slam_run_with_loop_closure(setup, tmp_path):  # noqa: F811
    """7 frames with tests/test_loop_closure.py's settings (every 2,
    min_gap 3, gate 0.3): one final refine over frames 1-6, and a
    checkpoint the JAX package's load_checkpoint reads."""
    from attentive_dfprior_tpu.models.scene import init_scene as j_init_scene
    from attentive_dfprior_tpu.utils.logger import load_checkpoint as j_load_checkpoint
    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem
    from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

    cfg = tiny_room_cfg()
    cfg["data"]["n_frames"] = 7
    cfg["mapping"].update(iters_first=6, iters=4)
    cfg["meshing"]["resolution"] = 32
    cfg["loop_closure"] = {"enable": True, "final_refine": True, "every": 2, "min_gap": 3, "overlap_gate": 0.3}
    slam = SLAMSystem(cfg, output=str(tmp_path), device="cpu")
    est = slam.run()
    records = [json.loads(ln) for ln in open(os.path.join(str(tmp_path), "metrics.jsonl"))]
    refine = [r for r in records if r["event"] == "loop_final_refine"]
    assert len(refine) == 1 and refine[0]["frames"] == 6
    assert np.isfinite(est).all() and slam.timings["loop"] > 0
    jparams, meta = j_load_checkpoint(os.path.join(str(tmp_path), "ckpts", "00006.npz"),
                                      j_init_scene(jax.random.PRNGKey(0), setup["scfg"]))
    assert meta["idx"] == 6
    np.testing.assert_array_equal(meta["estimate_c2w_list"], est)
    for a, b in zip(jax.tree_util.tree_leaves(jparams), tree_leaves(slam.params)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())
