"""Resume, the ATE tool, the phase timer and the synthetic frame cache of
the port, on the CPU.

  - a run to frame 4, then ``run.py --resume`` to frame 6: the restored
    system holds the first run's trajectory, keyframes and parameters, and
    the second run starts at frame 5;
  - a checkpoint written by the JAX package's Logger resumes in the port;
  - ``eval_ate`` equals the JAX package's at rtol 1e-12;
  - ``PhaseTimer.summary`` equals the JAX package's on one clock;
  - two ``Synthetic`` datasets on one config render each frame once.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu.models.scene import init_scene as j_init_scene
from attentive_dfprior_tpu.tools import eval_ate as j_eval_ate
from attentive_dfprior_tpu.utils.logger import Logger as JLogger
from attentive_dfprior_tpu.utils.profiling import PhaseTimer as JPhaseTimer
from attentive_dfprior_tpu_torch.tools import eval_ate
from attentive_dfprior_tpu_torch.utils.profiling import PhaseTimer, span, torch_trace
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves
from test_torch_slam import REPO, setup, tiny_room_cfg  # noqa: F401 (setup is a fixture)

TINY_YAML = """inherit_from: {repo}/configs/Synthetic/room_tracking.yaml
cam:
  H: 24
  W: 32
  fx: 24.0
  fy: 24.0
  cx: 15.5
  cy: 11.5
tracking:
  ignore_edge_W: 4
  ignore_edge_H: 4
  pixels: 40
  iters: 4
mapping:
  iters_first: 6
  iters: 4
  pixels: 60
rendering:
  N_samples: 8
  N_surface: 4
tsdf:
  voxel_size: 0.16
meshing:
  resolution: 32
loop_closure:
  refine_iters: 2
pretrained_decoders:
  low_high: {repo}/pretrained/low_high.npz
"""


def test_resume_continues_a_run(tmp_path, monkeypatch):
    from attentive_dfprior_tpu_torch import run as run_mod
    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem

    monkeypatch.chdir(REPO)  # room_tracking.yaml inherits by a relative path
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY_YAML.format(repo=REPO))
    out = str(tmp_path / "out")
    base = [str(cfg_path), "--output", out, "--device", "cpu"]
    first = run_mod.main(base + ["--end_idx", "5"])
    ckpt = os.path.join(out, "ckpts", "00004.npz")
    assert os.path.exists(ckpt)

    restored = SLAMSystem(first.cfg, output=str(tmp_path / "restored"), device="cpu")
    assert restored.resume(ckpt) == 5
    np.testing.assert_array_equal(restored.estimate_c2w_list[:5], first.estimate_c2w_list[:5])
    np.testing.assert_array_equal(restored.gt_c2w_list[:5], first.gt_c2w_list[:5])
    assert restored.keyframes.frame_idx == first.keyframes.frame_idx
    np.testing.assert_array_equal(restored.keyframes.poses_np(), first.keyframes.poses_np())
    K = len(first.keyframes)
    assert torch.equal(restored.keyframes.depth[:K], first.keyframes.depth[:K])
    assert torch.equal(restored.keyframes.color[:K], first.keyframes.color[:K])
    for a, b in zip(tree_leaves(restored.params), tree_leaves(first.params)):
        assert torch.equal(a, b.detach())

    n_records = sum(1 for _ in open(os.path.join(out, "metrics.jsonl")))
    second = run_mod.main(base + ["--resume", "--end_idx", "7"])
    assert os.path.exists(os.path.join(out, "ckpts", "00006.npz")) and second.last_idx == 6
    records = [json.loads(ln) for ln in open(os.path.join(out, "metrics.jsonl"))][n_records:]
    assert [r["idx"] for r in records if r["event"] == "track"] == [5, 6]
    refine = [r for r in records if r["event"] == "loop_final_refine"]
    assert len(refine) == 1 and refine[0]["frames"] == 2  # frames 5 and 6
    np.testing.assert_array_equal(second.estimate_c2w_list[:5], first.estimate_c2w_list[:5])
    assert np.isfinite(second.estimate_c2w_list[:7]).all()


def test_jax_checkpoint_resumes_in_the_port(setup, tmp_path):  # noqa: F811
    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem

    jparams = j_init_scene(jax.random.PRNGKey(4), setup["scfg"], setup["cfg"]["pretrained_decoders"]["low_high"])
    frames = setup["frames"]
    est = np.zeros((120, 4, 4), np.float32)
    gt = np.zeros((120, 4, 4), np.float32)
    for i, f in enumerate(frames):
        gt[i] = f[3]
        est[i] = f[3]
        est[i, :3, 3] += 0.01 * i
    sel = {2: [{"est_c2w": est[0]}, {"est_c2w": est[2]}]}
    path = JLogger(str(tmp_path / "ckpts"), verbose=False).log(
        2, jparams, est, gt, [0, 2], est[[0, 2]], keyframe_gt_c2w=gt[[0, 2]], selected_keyframes=sel,
    )
    slam = SLAMSystem(tiny_room_cfg(), output=str(tmp_path / "port"), device="cpu")
    assert slam.resume(path) == 3
    np.testing.assert_array_equal(slam.estimate_c2w_list, est)
    np.testing.assert_array_equal(slam.gt_c2w_list, gt)
    assert slam.keyframes.frame_idx == [0, 2]
    np.testing.assert_array_equal(slam.keyframes.poses_np(), est[[0, 2]])
    np.testing.assert_array_equal(slam.keyframes.depth[1].numpy(), frames[2][2])
    assert sorted(slam.selected_keyframes) == [2]
    np.testing.assert_array_equal(slam.selected_keyframes[2][1]["est_c2w"], est[2])
    for a, b in zip(jax.tree_util.tree_leaves(jparams), tree_leaves(slam.params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _random_trajectory(rng, n):
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, 3] = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    return poses


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_ate_equals_jax(seed):
    """Random trajectories with time offsets, unmatched stamps and a scale."""
    rng = np.random.default_rng(seed)
    gt = _random_trajectory(rng, 40)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.03, (40, 3))
    first = {float(i) + rng.uniform(0, 0.01): gt[i] for i in range(40)}
    second = {float(i): est[i] for i in range(35)}
    kw = dict(offset=0.003, max_difference=0.02, scale=1.1)
    port, ref = eval_ate.evaluate_ate(first, second, **kw), j_eval_ate.evaluate_ate(first, second, **kw)
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-12, err_msg=k)
    assert eval_ate.associate(list(first), list(second), 0.003) == j_eval_ate.associate(list(first), list(second), 0.003)


def test_eval_checkpoint_equals_jax(tmp_path):
    """A checkpoint with a non-finite and all-zero entries, read directly
    and through the CLI."""
    rng = np.random.default_rng(2)
    gt = _random_trajectory(rng, 30).astype(np.float32)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.02, (30, 3)).astype(np.float32)
    est[7] = np.nan
    est[20:] = 0.0
    path = str(tmp_path / "00019.npz")
    np.savez(path, gt_c2w_list=gt, estimate_c2w_list=est)
    port, ref = eval_ate.evaluate_checkpoint(path), j_eval_ate.evaluate_checkpoint(path)
    assert port.keys() == ref.keys() and port["compared_pose_pairs"] == 19
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-12, err_msg=k)
    # the CLI finds the latest checkpoint of a run folder and writes no plot
    os.makedirs(tmp_path / "run" / "ckpts")
    np.savez(str(tmp_path / "run" / "ckpts" / "00019.npz"), gt_c2w_list=gt, estimate_c2w_list=est)
    assert eval_ate.main(["--output", str(tmp_path / "run")]) == port
    assert sorted(os.listdir(tmp_path / "run")) == ["ckpts"]


def test_phase_timer_summary_equals_jax(monkeypatch):
    import time

    # steps exact in binary: every span is 0.25 s in both timers
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    timers = PhaseTimer(), JPhaseTimer()
    for t in timers:
        for name, rays in (("track", 800), ("map", 60_000), ("track", 800), ("loop", 0)):
            with t.phase(name, rays=rays):
                pass
    assert timers[0].summary() == timers[1].summary()
    assert timers[0].dump() == timers[1].dump()
    assert timers[0].rays_per_s("map") == timers[1].rays_per_s("map") > 0


def test_torch_trace_writes_a_trace(tmp_path):
    with torch_trace(None):
        torch.ones(3).sum()
    with torch_trace(str(tmp_path)):
        with span("Test.region", frame=7):
            torch.ones(3).sum()
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    # the spans beside the trace, on its time base: the region holds the sum it ran
    spans_file = tmp_path / traces[0].replace(".pt.trace.json", ".spans.json")
    kineto, ours = json.load(open(tmp_path / traces[0])), json.load(open(spans_file))
    assert ours["baseTimeNanoseconds"] == kineto.get("baseTimeNanoseconds", 0)
    (region,) = ours["traceEvents"]
    assert region["name"] == "Test.region" and region["args"] == {"frame": 7} and region["ph"] == "X"
    ops = [e for e in kineto["traceEvents"] if e.get("name") == "aten::sum"]
    for op in ops:  # the sum and the op it dispatches to
        assert region["ts"] <= op["ts"] and op["ts"] + op["dur"] <= region["ts"] + region["dur"]
        assert region["pid"] == op["pid"] and region["tid"] == op["tid"]
    assert ops


def test_frame_cache_renders_each_frame_once(monkeypatch):
    from attentive_dfprior_tpu_torch.utils import datasets
    from attentive_dfprior_tpu_torch.utils.synthetic import SyntheticScene

    cfg = tiny_room_cfg()
    cfg["data"]["n_frames"] = 4
    calls = []
    orig = SyntheticScene.render

    def counting(self, c2w):
        calls.append(np.asarray(c2w).copy())
        return orig(self, c2w)

    datasets.FRAME_CACHE.clear()
    monkeypatch.setattr(SyntheticScene, "render", counting)
    a, b = datasets.get_dataset(cfg), datasets.get_dataset(cfg)
    for ds in (a, b, a):
        for i in range(4):
            _, color, depth, c2w = ds[i]
            fresh_color, fresh_depth = orig(SyntheticScene.from_config(cfg), c2w)
            np.testing.assert_array_equal(color, fresh_color)
            np.testing.assert_array_equal(depth, fresh_depth)
            color[:] = -1.0  # a caller writing into a frame leaves the cache alone
    assert len(calls) == 4 and len(datasets.FRAME_CACHE) == 4
    cfg["data"]["arc_degrees"] = 30.0  # another scene renders anew
    datasets.get_dataset(cfg)[0]
    assert len(calls) == 5
    datasets.FRAME_CACHE.clear()


def test_prefetch_renders_missing_frames_once(monkeypatch):
    """``prefetch`` renders the frames not cached yet, on threads, equal to
    the frames rendered in turn; later reads render nothing."""
    from attentive_dfprior_tpu_torch.utils import datasets
    from attentive_dfprior_tpu_torch.utils.synthetic import SyntheticScene

    cfg = tiny_room_cfg()
    cfg["data"]["n_frames"] = 9
    datasets.FRAME_CACHE.clear()
    serial = [datasets.get_dataset(cfg)[i] for i in range(9)]
    datasets.FRAME_CACHE.clear()
    calls = []
    orig = SyntheticScene.render

    def counting(self, c2w):
        calls.append(1)
        return orig(self, c2w)

    monkeypatch.setattr(SyntheticScene, "render", counting)
    ds = datasets.get_dataset(cfg)
    ds[2]
    ds.prefetch(range(0, 9, 2))
    assert len(calls) == 5 and len(datasets.FRAME_CACHE) == 5
    ds.prefetch(range(9))
    assert len(calls) == 9
    for i in range(9):
        for a, b in zip(ds[i][1:], serial[i][1:]):
            np.testing.assert_array_equal(a, b)
    assert len(calls) == 9
    datasets.FRAME_CACHE.clear()
