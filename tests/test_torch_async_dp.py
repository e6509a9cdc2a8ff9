"""The async agents (``sync_method: loose | free``) on a shared dp group,
on the CPU at the tiny size of ``tests/test_torch_async.py:async_cfg``:

  - the decision log without sockets: a lead's run appends its decisions to
    a ``dist.HashStore`` (``slam/schedule.py:UnitSchedule``), and a follower
    in the same process, its mapper slowed, replays them: the same
    ``metrics.jsonl`` events, the same log, and ``torch.equal`` final
    leaves and trajectory;
  - two gloo processes (``tools/multihost_smoke.py:slam_worker``, skipped
    where the sandbox refuses local sockets, as tests/test_torch_multihost.py
    is): under ``tracking.gt_camera`` loose and free end with both ranks'
    leaves ``torch.equal`` to each other and to strict on 2 ranks; with
    tracking on, the ranks end bit-equal and the trajectory within the JAX
    split test's 20 cm of the strict single run (tests/test_sharding.py:306);
    the follower's log is a replay of rank 0's;
  - the JAX package's loose and free on a shared dp mesh of 2 of the 8
    virtual devices (tests/test_sharding.py:348 runs it on 8): the port's
    schedule on 2 ranks (mapped frames, tracked frames, publishes with the
    skipped ones, keyframes) is the JAX run's, with tracking and under
    ``gt_camera``, and the port's checkpoint loads in the JAX
    ``load_checkpoint`` (the packages draw different pixels, so the maps
    are not held leaf against leaf);
  - a crash in rank 1's mapper fails both processes, each with rank 1's
    error, in bounded time.

The JAX runs go in a child process with a time limit of its own
(``JAX_DP_TIMEOUT_S``): a hang there fails this module's JAX tests alone,
not the whole suite at its time limit.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from attentive_dfprior_tpu_torch.slam.schedule import Peers, UnitSchedule
from attentive_dfprior_tpu_torch.slam.system import SLAMSystem
from attentive_dfprior_tpu_torch.tools import multihost_smoke as mh
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves
from test_torch_async import N_FRAMES, async_cfg, load_in_jax, run_jax, schedule
from test_torch_multihost import _sockets_allowed

TRAJ_GATE_M = 0.20  # the JAX split test's 20 cm against the strict single-device run
# tests/test_torch_async.py:async_cfg as --set overrides of room_tracking.yaml, for the child processes
ASYNC_TINY = mh.TINY_SLAM + [
    f"data.n_frames={N_FRAMES}", "mapping.iters_first=6", "mapping.iters=4", "mapping.BA=False",
    "mapping.color_refine=False", "tracking.iters=2", "meshing.resolution=16",
]
needs_sockets = pytest.mark.skipif(not _sockets_allowed(), reason="no local sockets")
TESTS = os.path.dirname(os.path.abspath(__file__))
JAX_DP_TIMEOUT_S = 600  # the three JAX runs take about 30 s, most of it compiling
# the child of the jax_dp fixture: JAX on 8 virtual CPU devices as tests/conftest.py sets it up
JAX_DP_CHILD = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", os.path.join(sys.argv[1], ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
sys.path.insert(0, sys.argv[1])
import test_torch_async_dp
test_torch_async_dp.jax_dp_child(sys.argv[2])
"""


def spec(work, name: str, sync: str, gt_camera: bool, dp: bool = True, **kw):
    overrides = ASYNC_TINY + [f"tracking.gt_camera={gt_camera}"] + (["parallel.enable=True"] if dp else [])
    return dict(config=mh.ROOM_TRACKING, overrides=overrides, end_idx=N_FRAMES, device="cpu", threads=1, sync=sync,
                output=os.path.join(str(work), name), record=os.path.join(str(work), name), **kw)


def launch_all(work, runs):
    """Start every run of ``runs`` ({name: (spec, world)}) at once; their
    results by name."""
    started = {name: mh.start("slam", s, world) for name, (s, world) in runs.items()}
    return {name: mh.finish(handle, timeout=300) for name, handle in started.items()}


def events(out):
    return [(r["event"], r.get("idx")) for r in map(json.loads, open(os.path.join(out, "metrics.jsonl")))]


def test_unit_schedule_under_thread_stress():
    """The schedule alone: a lead and three followers, each with a map
    thread and a main thread asking for their units in their own order,
    all at once under a short switch interval: every rank runs one unit at
    a time and in the lead's order, and every follower's log is the lead's."""
    import random
    import sys
    import threading

    store = dist.HashStore()
    maps, frames = list(range(0, 40, 5)), list(range(1, 40))
    errors, running = [], {}

    def rank_main(rank: int):
        sched = UnitSchedule(store, Peers(store, rank, range(4)), lead=rank == 0)
        lock, active, order = threading.Lock(), [0], []
        rng = random.Random(rank)

        def body(kind, idx, decide=dict):
            with sched.unit(kind, idx, decide) as rec:
                with lock:
                    active[0] += 1
                    assert active[0] == 1, "two units at once"
                    order.append((kind, idx))
                time.sleep(rng.random() * 1e-3)
                with lock:
                    active[0] -= 1
            return rec

        def mapper():
            for i in maps:
                body("map", i, lambda: {"publish": rng.random() < 0.5})

        def main():
            for i in frames:
                body("track", i, lambda: {"read": len(order)})
            body("final", frames[-1])

        threads = [threading.Thread(target=f) for f in (mapper, main)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            running[rank] = (sched.records, order)
        except BaseException as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ranks = [threading.Thread(target=rank_main, args=(r,)) for r in range(4)]
        for t in ranks:
            t.start()
        for t in ranks:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in ranks), errors
    lead_log, lead_order = running[0]
    assert len(lead_log) == len(maps) + len(frames) + 1 and lead_log[-1]["unit"] == "final"
    for r in (1, 2, 3):
        log, order = running[r]
        assert log == lead_log and order == lead_order == [(x["unit"], x["idx"]) for x in lead_log]


class SlowMapGrants(UnitSchedule):
    """A lead whose mapper asks for each map unit 0.3 s late: its tracker
    takes the grants first and reads staler snapshots."""

    def unit(self, kind, idx, decide=dict):
        if kind == "map":
            time.sleep(0.3)
        return super().unit(kind, idx, decide)


@pytest.mark.parametrize("sync,slowed", [("loose", "follower"), ("free", "follower"), ("free", "lead")])
def test_follower_replays_the_lead_bit_for_bit(tmp_path, sync, slowed):
    """One ``HashStore``, no sockets: the lead runs and logs, then a
    follower replays the log. ``slowed``: the follower's map jobs take
    0.3 s longer (it must run in the log's order, not its own timing), or
    the lead's mapper asks for its grants late (its log then differs from
    an unslowed one: the tracker reads older snapshots)."""
    torch.set_num_threads(1)
    store = dist.HashStore()
    runs = {}
    for role in ("lead", "follower"):
        slam = SLAMSystem(async_cfg(sync), output=str(tmp_path / role), device="cpu")
        if role == "follower" == slowed:
            map_frame = slam._map_frame

            def slow(*a, **k):
                time.sleep(0.3)
                return map_frame(*a, **k)

            slam._map_frame = slow
        kind = SlowMapGrants if role == "lead" == slowed else UnitSchedule
        peers = Peers(store, 0 if role == "lead" else 1, (0,) if role == "lead" else (0, 1))
        slam.run(schedule=kind(store, peers, lead=role == "lead", sync=slam._sync_stream))
        runs[role] = slam
    lead, follower = runs["lead"], runs["follower"]
    assert follower.schedule_records == lead.schedule_records
    units = [(r["unit"], r["idx"]) for r in lead.schedule_records]
    assert [i for u, i in units if u == "map"] == [0, 5, N_FRAMES - 1]
    assert [i for u, i in units if u == "track"] == list(range(1, N_FRAMES)) and units[-1] == ("final", N_FRAMES - 1)
    if slowed == "lead":  # every frame is tracked before map 5 is granted: all read frame 0's snapshot
        assert [r["read"] for r in lead.schedule_records if r["unit"] == "track"] == [0] * (N_FRAMES - 1)
    assert events(follower.output) == events(lead.output)
    for a, b in zip(tree_leaves(lead.params), tree_leaves(follower.params)):
        assert torch.equal(a.detach(), b.detach())
    assert np.array_equal(lead.estimate_c2w_list, follower.estimate_c2w_list)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    if not _sockets_allowed():
        pytest.skip("no local sockets")
    work = tmp_path_factory.mktemp("async_dp")
    runs = {
        "strict_dp_gt": (spec(work, "strict_dp_gt", "strict", True), 2),
        "loose_dp_gt": (spec(work, "loose_dp_gt", "loose", True), 2),
        "free_dp_gt": (spec(work, "free_dp_gt", "free", True), 2),
        "loose_dp": (spec(work, "loose_dp", "loose", False), 2),
        "strict_single": (spec(work, "strict_single", "strict", False, dp=False), 0),
    }
    return work, launch_all(work, runs)


@pytest.mark.parametrize("sync", ["loose", "free"])
def test_shared_dp_gt_camera_equals_strict_on_two_ranks(dp_runs, sync):
    work, res = dp_runs
    runs = res[f"{sync}_dp_gt"]
    assert [r["role"] for r in runs] == ["shared", "shared"] and [r["writer"] for r in runs] == [True, False]
    cmp = mh.compare_async(runs, str(work / f"{sync}_dp_gt"), str(work / "strict_dp_gt"))
    assert cmp["replicas_equal"] and cmp["trajectories_equal"] and cmp["logs_replayed"], cmp
    assert cmp["equal_to_reference"] and cmp["max_abs_diff_to_reference"] == 0.0, cmp
    assert cmp["n_leaves"] == 82 and cmp["n_log_records"] == 10  # 3 maps, 6 tracked frames, the final unit
    ev = runs[0]["schedule_events"]
    maps = [i for e, i in ev if e == "map"]
    assert maps == [0, 5, N_FRAMES - 1] and sum(e in ("publish", "publish_skip") for e, _ in ev) == len(maps)
    assert all(r["launches"]["halo_fold"] == 0 for r in runs)  # the CPU runs K1's plain version


def test_shared_dp_loose_tracking_ranks_bit_equal(dp_runs):
    work, res = dp_runs
    runs = res["loose_dp"]
    cmp = mh.compare_async(runs, str(work / "loose_dp"), str(work / "strict_single"))
    assert cmp["replicas_equal"] and cmp["trajectories_equal"] and cmp["logs_replayed"], cmp
    assert cmp["traj_max_diff_to_reference_mm"] < TRAJ_GATE_M * 1e3, cmp
    assert all(np.isfinite(r["track_losses"]).all() and r["all_map_losses_finite"] for r in runs)
    assert len(runs[0]["track_losses"]) == N_FRAMES - 1 and runs[1]["track_losses"] == []  # the writer's alone
    reads = [r["read"] for r in runs[0]["schedule"] if r["unit"] == "track"]
    assert reads == sorted(reads) and reads[0] == 0


def jax_dp_child(work: str) -> None:
    """The JAX package's async runs on a shared mesh of 2 devices, in the
    ``jax_dp`` fixture's child: each run's ``metrics.jsonl`` records, its
    config, and its mesh's layout, pickled to ``<work>/jax_dp.pkl``."""
    torch.set_num_threads(1)
    shared = {"enable": True, "n_devices": 2}
    out = {}
    for name, sync, gt in (("loose_dp", "loose", False), ("loose_dp_gt", "loose", True),
                           ("free_dp_gt", "free", True)):
        jslam, records = run_jax(async_cfg(sync, gt_camera=gt), os.path.join(work, name), parallel=shared)
        out[name] = {"records": records, "cfg": jslam.cfg, "track_mesh_is_mesh": jslam.track_mesh is jslam.mesh,
                     "n_devices": len(jslam.mesh.devices.flat), "kf_idx": list(jslam.keyframes.frame_idx)}
    with open(os.path.join(work, "jax_dp.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def jax_dp(tmp_path_factory):
    """The JAX package's async runs on a shared mesh of 2 devices, in a
    child process bounded by JAX_DP_TIMEOUT_S: {name: (a summary of the
    JAX system (its ``cfg``, whether the tracker's mesh is the mapper's, the
    mesh's device count, its keyframes), its ``metrics.jsonl`` records)}."""
    work = tmp_path_factory.mktemp("jax_dp")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    try:
        proc = subprocess.run([sys.executable, "-c", JAX_DP_CHILD, TESTS, str(work)], cwd=os.path.dirname(TESTS),
                              env=env, capture_output=True, text=True, timeout=JAX_DP_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"the JAX dp runs did not end within {JAX_DP_TIMEOUT_S} s") from e
    if proc.returncode != 0:
        raise RuntimeError(f"the JAX dp runs failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    with open(work / "jax_dp.pkl", "rb") as f:
        runs = pickle.load(f)
    return {name: (types.SimpleNamespace(cfg=r["cfg"], track_mesh_is_mesh=r["track_mesh_is_mesh"],
                                         n_devices=r["n_devices"],
                                         keyframes=types.SimpleNamespace(frame_idx=r["kf_idx"])), r["records"])
            for name, r in runs.items()}


@pytest.mark.parametrize("name", ["loose_dp", "loose_dp_gt", "free_dp_gt"])
def test_shared_dp_schedule_matches_jax(dp_runs, jax_dp, name):
    work, res = dp_runs
    records = [json.loads(ln) for ln in open(os.path.join(str(work / name), "metrics.jsonl"))]
    jslam, jrecords = jax_dp[name]
    assert jslam.track_mesh_is_mesh and jslam.n_devices == 2
    assert schedule(records) == schedule(jrecords)
    maps, n_map, n_track, n_pub = schedule(records)
    assert maps == [0, 5, N_FRAMES - 1] and n_track == N_FRAMES - 1 and n_pub == n_map
    ckpt = os.path.join(str(work / name), "ckpts", f"{N_FRAMES - 1:05d}.npz")
    jleaves, meta = load_in_jax(ckpt, jslam)
    assert list(meta["keyframe_idx_list"]) == jslam.keyframes.frame_idx == [0, 5]
    with np.load(os.path.join(str(work), f"{name}.rank0.npz")) as ours:
        leaves = [ours[k] for k in sorted(k for k in ours.files if k.startswith("p"))]
    assert len(jleaves) == len(leaves) == 82
    for a, b in zip(jleaves, leaves):
        np.testing.assert_array_equal(a, b)


@needs_sockets
def test_crash_on_rank_1_fails_both_ranks(tmp_path):
    """Rank 1's mapper raises at its first job: rank 1 fails with its
    error, and rank 0, whose mapper waits in the first map job's all-reduce,
    fails with rank 1's error too, well inside the group's timeout."""
    t0 = time.perf_counter()
    _, procs = mh.start("slam", spec(tmp_path, "crash", "loose", False, crash_rank=1), 2)
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    assert all(p.returncode != 0 for p in procs), outs
    assert "RuntimeError: mapper failed on rank 1" in outs[1], outs[1][-3000:]
    assert "PeerFailure: rank 1 failed: RuntimeError: mapper failed on rank 1" in outs[0], outs[0][-3000:]
    assert wall < 60.0
