"""The port's final refine (``LoopCloser.final_refine``) against the
benchmark's plain reference of it (``benchmark/reference/refine.py``), on
the CPU at a tiny size: ``configs/Synthetic/room_tracking.yaml`` as the
benchmark runs it, with a 24x32 camera, 30 rays, an 0.125 m prior and 3 or
6 iterations at the shipped ``lr_final_factor`` of 0.1, so the decay acts.
Weights, prior, frames and trajectory are seeded by the benchmark's
generator.

Poses are held within a tenth of one Adam step (0.1 x the refine's lr, as
``tests/test_torch_loop_closure.py`` holds re-localizations to the JAX
package): both sides run float32, their losses agree to round-off, and
Adam's normalized steps turn that into a pose gap under 3e-4 here (a
gradient component near zero can step by a different amount on either
side), where the refine moves a pose by 0.06-0.12. Entries the refine
must not move are held bit for bit. Then the counters, the trust region
where it binds, the clamp's rule on its own, the rate schedule, and the
spans under ``recording()``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from attentive_dfprior_tpu_torch.camera import Camera  # noqa: E402
from attentive_dfprior_tpu_torch.models.scene import SceneConfig  # noqa: E402
from attentive_dfprior_tpu_torch.ops.pose import clamp_pose_update  # noqa: E402
from attentive_dfprior_tpu_torch.render.renderer import RenderConfig  # noqa: E402
from attentive_dfprior_tpu_torch.slam.keyframes import KeyframeStore  # noqa: E402
from attentive_dfprior_tpu_torch.slam.loop_closure import LoopCloser  # noqa: E402
from attentive_dfprior_tpu_torch.slam.tracker import Tracker  # noqa: E402
from attentive_dfprior_tpu_torch.utils.profiling import children, recording, spans, take  # noqa: E402
from benchmark import generate  # noqa: E402
from benchmark.entries.refine import Frames, perturbed  # noqa: E402
from benchmark.reference import refine  # noqa: E402
from benchmark.reference.steps import leaves, rebuild  # noqa: E402

LR = 0.01  # room_tracking.yaml's loop_closure.lr
TOL = 0.1 * LR
TRAJECTORY = {"amplitude": 0.2, "periods": [240, 180, 300], "yaw_period": 1080, "pitch": 0.15}
BAD = 3  # a non-finite entry


def tiny_cfg(iters: int) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", "synthetic-room_tracking.json")) as f:
        cfg = json.load(f)
    cfg["mapping"]["bound"] = [[-1.0, 1.5], [-1.0, 1.2], [-0.8, 1.0]]
    cfg["cam"].update(H=24, W=32, fx=20.0, fy=20.0, cx=15.5, cy=11.5)
    cfg["tsdf"]["voxel_size"] = 0.125
    cfg["tracking"].update(pixels=30, ignore_edge_W=2, ignore_edge_H=2)
    cfg["loop_closure"]["refine_iters"] = iters
    assert cfg["tracking"]["lr_final_factor"] == 0.1 and cfg["loop_closure"]["lr"] == LR
    return cfg


def build(iters: int, seed: int, n: int = 6):
    """The port's agents and the seeded inputs: a dict."""
    cfg = tiny_cfg(iters)
    tsdf, bnds = generate.make_prior(cfg, seed, "cpu")
    scene = generate.make_scene(cfg, seed, "cpu")
    colors, depths = generate.make_frames(cfg, 4, (0.5, 4.0), seed, "cpu")
    poses = generate.trajectory(cfg, n, TRAJECTORY, seed)
    est = perturbed(poses, (2.0, 10.0), 2.0, seed)
    est[BAD] = np.nan
    r = cfg["rendering"]
    rcfg = RenderConfig(N_samples=int(r["N_samples"]), N_surface=int(r["N_surface"]),
                        N_importance=int(r["N_importance"]), lindisp=bool(r["lindisp"]),
                        perturb=float(r["perturb"]), occupancy=True)
    scene_cfg = SceneConfig.from_config(cfg, pretrained_loaded=True)
    cam = generate.camera(cfg)
    tracker = Tracker(cfg, Camera(**cam), rcfg, scene_cfg.bound, tsdf, bnds, "cpu")
    closer = LoopCloser(cfg, tracker, KeyframeStore(4, cam["H"], cam["W"], torch.device("cpu")), Camera(**cam), rcfg,
                        scene_cfg.bound, tsdf, bnds)
    dataset = Frames(colors.numpy(), depths.numpy(), poses)
    return dict(cfg=cfg, tsdf=tsdf, bnds=bnds, scene=scene, cam=cam, dataset=dataset, est=est, tracker=tracker,
                closer=closer)


def reference(s, seed: int, start: int, n: int, **opts):
    cfg = s["cfg"]
    scene = rebuild(generate.scene_specs(cfg), [v for _, v in leaves(s["scene"])])
    bound = torch.as_tensor(generate.scene_bound(cfg), dtype=torch.float32)

    def frame(t):
        _, c, d, _ = s["dataset"][t]
        return torch.as_tensor(c), torch.as_tensor(d)

    return refine.refine_block(scene, s["est"], frame, torch.Generator().manual_seed(seed), start, n,
                               dict(refine.options(cfg), **opts), s["tsdf"], torch.as_tensor(s["bnds"]), bound,
                               s["cam"], cfg["rendering"])


@pytest.mark.parametrize("iters", [3, 6])
@pytest.mark.parametrize("seed", [2, 2**31 + 17])
def test_final_refine_matches_the_reference(iters, seed):
    s = build(iters, seed)
    lc = s["closer"]
    out = s["est"].copy()
    assert lc.final_refine(s["dataset"], out, s["scene"], 0, 6, torch.Generator().manual_seed(seed))
    ref, refined, skipped = reference(s, seed, 0, 6)
    moved = [1, 2, 4, 5]
    np.testing.assert_allclose(out[moved], ref[moved], atol=TOL)
    assert np.abs(ref[moved] - s["est"][moved]).max() > 50 * TOL  # the refine moved them
    # entry 0 never moves; the non-finite entry is left as it was
    assert out[0].tobytes() == s["est"][0].tobytes() and out[BAD].tobytes() == s["est"][BAD].tobytes()
    assert (refined, skipped) == (4, 1)
    assert (lc.refined, lc.skipped, lc.relocalizations, lc.relaxations) == (4, 1, 4, 0)


def test_the_trust_region_binds_as_in_the_reference():
    seed, max_dt, max_deg = 3, 0.004, 0.2  # the refine moves a pose some cm and degrees here
    s = build(3, seed)
    lc = s["closer"]
    lc.refine_max_dt, lc.refine_max_rot_deg = max_dt, max_deg
    out = s["est"].copy()
    lc.final_refine(s["dataset"], out, s["scene"], 1, 3, torch.Generator().manual_seed(seed))
    ref, _, _ = reference(s, seed, 1, 3, max_dt=max_dt, max_rot=float(np.deg2rad(max_deg)))
    free, _, _ = reference(s, seed, 1, 3, max_dt=1.0, max_rot=np.pi)
    for t in (1, 2):
        old = s["est"][t].astype(np.float64)
        assert np.linalg.norm(free[t][:3, 3] - old[:3, 3]) > 2 * max_dt  # the clamp binds
        np.testing.assert_allclose(out[t], ref[t], atol=1e-5)
        assert np.isclose(np.linalg.norm(out[t][:3, 3] - old[:3, 3]), max_dt, rtol=1e-4)
        dR = out[t][:3, :3].astype(np.float64) @ old[:3, :3].T
        angle = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert np.isclose(angle, max_deg, rtol=2e-2)


def _rotation(axis, angle):
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)


def _pose(R, t):
    p = np.eye(4, dtype=np.float32)
    p[:3, :3], p[:3, 3] = R, t
    return p


def test_the_clamp_follows_its_rule():
    rng = np.random.default_rng(0)
    cases = []
    for _ in range(50):
        old = _pose(_rotation(rng.normal(size=3), rng.uniform(0, np.pi)), rng.normal(size=3))
        step = _rotation(rng.normal(size=3), rng.uniform(0, 0.6))
        new = _pose(step @ old[:3, :3], old[:3, 3] + rng.normal(size=3) * rng.uniform(0.001, 0.3))
        cases.append((old, new, rng.uniform(0.01, 0.2), rng.uniform(0.01, 0.3)))
    old = _pose(np.eye(3), np.zeros(3))
    cases.append((old, _pose(np.diag([1.0, -1.0, -1.0]), [0.5, 0.0, 0.0]), 0.1, 0.1))  # a half turn: rotation kept
    cases.append((old, _pose(_rotation([0, 0, 1], 0.05), [0.01, 0.0, 0.0]), 0.1, 0.1))  # inside: unchanged
    for old, new, max_dt, max_rot in cases:
        port, ref = clamp_pose_update(old, new, max_dt, max_rot), refine.clamp(old, new, max_dt, max_rot)
        np.testing.assert_allclose(port, ref, atol=1e-6)
    out = refine.clamp(*cases[-2])
    np.testing.assert_array_equal(out[:3, :3], np.eye(3))
    np.testing.assert_allclose(out[:3, 3], [0.1, 0.0, 0.0], atol=1e-7)
    np.testing.assert_allclose(refine.clamp(*cases[-1]), cases[-1][1], atol=1e-7)


def test_the_rate_schedule():
    assert refine.lr_scales(3, 0.1) == pytest.approx([1.0, 1.0, 0.1 ** 0.5])
    assert refine.lr_scales(6, 0.1) == pytest.approx([1.0, 1.0, 1.0, 1.0, 0.1 ** 0.5, 0.1])
    scales = refine.lr_scales(100, 0.1)
    assert scales[:51] == [1.0] * 51 and scales[-1] == pytest.approx(0.1)
    assert all(a > b for a, b in zip(scales[50:], scales[51:]))
    assert refine.lr_scales(4, 1.0) == [1.0] * 4 and refine.lr_scales(1, 0.1) == [1.0]


def _stub_graphs(monkeypatch, tracker):
    """The tracker's program on a stub CUDA graph, so a refine runs the
    card's span tree on the CPU: two warm-ups, a capture, then replays."""
    from attentive_dfprior_tpu_torch.ops.cuda import build as kernels_build
    from attentive_dfprior_tpu_torch.utils.step_graph import StepGraphs
    from test_torch_step_graph import StubGraph

    monkeypatch.setattr(kernels_build, "capturing_stream", lambda: 0 if StubGraph.capturing else None)
    tracker.graphs = StepGraphs("graph", "cpu", graph_factory=StubGraph)


def _tree(records, root):
    return (root.name, [_tree(records, c) for c in sorted(children(root, records), key=lambda s: s.start_ns)])


def test_the_spans_nest(monkeypatch):
    iters = 3
    s = build(iters, 4)
    lc = s["closer"]
    _stub_graphs(monkeypatch, s["tracker"])
    est = s["est"].copy()
    lc.final_refine(s["dataset"], est, s["scene"], 1, 2)  # warm-ups and the capture
    take()
    with recording():
        lc.final_refine(s["dataset"], est, s["scene"], 0, 4)
    records = spans()
    (root,) = [r for r in records if r.parent is None]
    assert root.attrs == {"start": 0, "n": 4, "frames": 2}
    entry = ("LoopCloser.relocalize", [("LoopCloser.frame_in", []), ("Tracker.inputs", []),
                                       *[("StepGraph.replay", [])] * iters, ("LoopCloser.pose_to_host", [])])
    assert _tree(records, root) == ("LoopCloser.final_refine", [entry, entry])  # entry 3 is skipped
    assert [c.attrs for c in children(root, records)] == [{"frame": 1, "iters": iters}, {"frame": 2, "iters": iters}]

    # one relaxation: keyframes at frames 0, 2, 4, frame 0's never re-localized; the 24x32 camera lies
    # inside the revisit scorer's 20 px margin, so every score is 0, which a gate of 0 passes
    for f in (0, 2, 4):
        _, c, d, _ = s["dataset"][f]
        lc.keyframes.add(f, c, d, s["est"][f], s["dataset"].poses[f])
    lc.enable, lc.overlap_gate, lc.min_gap = True, 0.0, 1
    take()
    with recording():
        assert lc.maybe_relax(5, s["dataset"][4][2], s["est"][4], s["est"].copy(), s["scene"])
    records = spans()
    (root,) = [r for r in records if r.parent is None]
    assert root.attrs == {"idx": 5, "keyframes": 3}
    relocalized = [("LoopCloser.relocalize", [("LoopCloser.frame_in", []), ("Tracker.inputs", []),
                                              *[("StepGraph.replay", [])] * lc.tracker.num_cam_iters,
                                              ("LoopCloser.pose_to_host", [])])] * 2
    assert _tree(records, root) == ("LoopCloser.relax", relocalized)
    assert (lc.refined, lc.skipped, lc.relaxations, lc.relocalizations) == (3, 1, 1, 5)


def test_no_span_outside_recording():
    s = build(3, 5)
    take()
    out = s["est"].copy()
    s["closer"].final_refine(s["dataset"], out, s["scene"], 0, 4, torch.Generator().manual_seed(5))
    assert spans() == [] and s["closer"].refined == 2
