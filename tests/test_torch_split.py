"""``parallel.split`` (the mapper on ranks [0, k), the tracker on the next
m, the scene published by broadcast; ``slam/system.py:_run_split``) on the
CPU, at the tiny size of ``tests/test_torch_async.py:async_cfg``:

  - ``split_counts`` raises where the JAX ``split_meshes_from_config``
    raises, on the same configs and 8 devices (8 ranks here), and also
    where ``map + track`` is smaller than the world (one process drives one
    device); strict with a split raises the JAX package's ``ValueError``;
  - split 1+1 as two gloo processes (skipped where the sandbox refuses
    local sockets): under ``tracking.gt_camera`` the published map is
    ``torch.equal`` to the one-process strict run's (one map rank does no dp
    arithmetic); with tracking on, the JAX loose schedule (maps 0, 5, 6,
    keyframes 0 and 5, every map published or skipped) and the trajectory
    within the JAX split test's 20 cm of the strict single run
    (tests/test_sharding.py:306); split 2+1 and 1+2, each agent's dp group
    bit-equal;
  - the same split 1+1 in the JAX package (``parallel.split`` over two of
    the 8 virtual devices), with tracking and under ``gt_camera``: the
    port's schedule (mapped frames, tracked frames, publishes with the
    skipped ones, keyframes) is the JAX run's, and the port's checkpoint
    loads in the JAX ``load_checkpoint``. Under ``gt_camera`` the JAX split
    map is its one-device loose map bit for bit, as the port's is its
    one-process map. The two packages draw different pixels (a
    ``torch.Generator`` against JAX keys), so their maps are held to each
    other only through those relations, not leaf against leaf;
  - ``tools/bench_async.py --split 1,1 --device cpu`` records the JAX
    harness's reps and keys.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu_torch.parallel.sharding import split_counts
from attentive_dfprior_tpu_torch.tools import multihost_smoke as mh
from test_torch_async import N_FRAMES, async_cfg, load_in_jax, run_jax, schedule
from test_torch_async_dp import ASYNC_TINY, TRAJ_GATE_M, launch_all, spec
from test_torch_multihost import _sockets_allowed

SPLIT = {"map": 1, "track": 1}
SPLIT_CONFIGS = [
    {},
    {"parallel": {"enable": True}},
    {"parallel": {"enable": False, "split": {"map": 6, "track": 2}}},
    {"parallel": {"enable": True, "split": {"map": 0, "track": 2}}},
    {"parallel": {"enable": True, "split": {"map": 3, "track": 0}}},
    {"parallel": {"enable": True, "split": {"track": 2}}},
    {"parallel": {"enable": True, "split": {"map": 6, "track": 2}}},
    {"parallel": {"enable": True, "split": {"map": 1, "track": 7}}},
    {"parallel": {"enable": True, "split": {"map": 7, "track": 2}}},
    {"parallel": {"enable": True, "split": {"map": 1, "track": 1}}},
]


@pytest.mark.parametrize("cfg", SPLIT_CONFIGS, ids=[json.dumps(c) for c in SPLIT_CONFIGS])
def test_split_counts_raise_where_jax_raises(cfg):
    import jax

    from attentive_dfprior_tpu.parallel.sharding import split_meshes_from_config

    world = len(jax.devices())
    assert world == 8
    try:
        meshes = split_meshes_from_config(cfg)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            split_counts(cfg, world)
        # the same message up to the JAX package's closing word
        assert str(ours.value).split(" devices")[0] == str(e).split(" devices")[0]
        return
    if meshes is None:
        assert split_counts(cfg, world) is None
        return
    k, m = (len(mesh.devices.flat) for mesh in meshes)
    if k + m == world:
        assert split_counts(cfg, world) == (k, m)
    else:  # JAX leaves devices idle; one process drives one device here
        with pytest.raises(ValueError, match=f"launch {k + m} processes"):
            split_counts(cfg, world)


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    if not _sockets_allowed():
        pytest.skip("no local sockets")
    work = tmp_path_factory.mktemp("split")
    runs = {
        "split_gt": (spec(work, "split_gt", "loose", True, dp=False, split=SPLIT), 2),
        "split": (spec(work, "split", "loose", False, dp=False, split=SPLIT), 2),
        "strict_single_gt": (spec(work, "strict_single_gt", "strict", True, dp=False), 0),
        "strict_single": (spec(work, "strict_single", "strict", False, dp=False), 0),
        "split_2_1": (spec(work, "split_2_1", "free", False, dp=False, split={"map": 2, "track": 1}), 3),
        "split_1_2": (spec(work, "split_1_2", "loose", False, dp=False, split={"map": 1, "track": 2}), 3),
    }
    # strict with a split, in two processes of their own: both must fail
    strict_split = mh.start("slam", spec(work, "strict_split", "strict", False, dp=False, split=SPLIT), 2)
    res = launch_all(work, runs)
    _, procs = strict_split
    try:
        res["strict_split"] = [(p.communicate(timeout=300)[0], p.returncode) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return work, res


def test_strict_with_split_raises(split_runs):
    _, res = split_runs
    for out, rc in res["strict_split"]:
        assert rc != 0
        assert "ValueError: parallel.split requires sync_method 'loose' or 'free'" in out, out[-2000:]


def test_split_gt_camera_map_equals_strict_single(split_runs):
    work, res = split_runs
    runs = res["split_gt"]
    assert [(r["role"], r["writer"]) for r in runs] == [("map", False), ("track", True)]
    cmp = mh.compare_async(runs, str(work / "split_gt"), str(work / "strict_single_gt"))
    assert cmp["replicas_equal"] and cmp["equal_to_reference"] and cmp["max_abs_diff_to_reference"] == 0.0, cmp
    assert cmp["traj_max_diff_to_reference_mm"] == 0.0 and cmp["n_leaves"] == 82
    ours = np.load(os.path.join(str(work / "split_gt"), "ckpts", f"{N_FRAMES - 1:05d}.npz"))
    ref = np.load(os.path.join(str(work / "strict_single_gt"), "ckpts", f"{N_FRAMES - 1:05d}.npz"))
    assert sorted(ours.files) == sorted(ref.files)
    for k in ref.files:  # the writer's checkpoint: scene, trajectories, keyframes
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_split_tracking_keeps_the_jax_loose_schedule(split_runs):
    work, res = split_runs
    runs = res["split"]
    track = runs[1]
    ev = track["schedule_events"]
    maps = [i for e, i in ev if e == "map"]
    assert maps == [0, 5, N_FRAMES - 1]
    assert [i for e, i in ev if e in ("publish", "publish_skip")] == maps  # every map published or skipped
    assert [i for e, i in ev if e == "track"] == list(range(1, N_FRAMES))
    ckpt = np.load(os.path.join(str(work / "split"), "ckpts", f"{N_FRAMES - 1:05d}.npz"))
    assert list(ckpt["keyframe_idx_list"]) == [0, 5]
    # the map rank's jobs: each map in order, a final publish where the last one was skipped, then stop
    jobs = [(r["job"], r["idx"]) for r in runs[0]["schedule"]]
    assert jobs[:3] == [("map", 0), ("map", 5), ("map", N_FRAMES - 1)] and jobs[-1] == ("stop", None)
    stale = track["schedule"][-1]
    assert stale["unit"] == "final" and (("publish", N_FRAMES - 1) in jobs) == stale["stale"]
    cmp = mh.compare_async(runs, str(work / "split"), str(work / "strict_single"))
    assert cmp["replicas_equal"], cmp  # the final publish is the map rank's scene
    assert cmp["traj_max_diff_to_reference_mm"] < TRAJ_GATE_M * 1e3, cmp
    assert np.isfinite(track["track_losses"]).all() and runs[0]["all_map_losses_finite"]


@pytest.fixture(scope="module")
def jax_split(tmp_path_factory):
    """The JAX package's loose runs on the same config: split 1+1 with
    tracking and under ``gt_camera``, and one device under ``gt_camera``."""
    torch.set_num_threads(1)
    work = tmp_path_factory.mktemp("jax_split")
    split = {"enable": True, "split": dict(SPLIT)}
    return {name: run_jax(async_cfg("loose", gt_camera=gt), work / name, parallel=par)
            for name, gt, par in (("split", False, split), ("split_gt", True, split), ("loose_gt", True, None))}


@pytest.mark.parametrize("name", ["split", "split_gt"])
def test_split_schedule_matches_jax(split_runs, jax_split, name):
    work, res = split_runs
    records = [json.loads(ln) for ln in open(os.path.join(str(work / name), "metrics.jsonl"))]
    jslam, jrecords = jax_split[name]
    assert [d.id for d in jslam.mesh.devices.flat] != [d.id for d in jslam.track_mesh.devices.flat]
    assert schedule(records) == schedule(jrecords)
    maps, n_map, n_track, n_pub = schedule(records)
    assert maps == [0, 5, N_FRAMES - 1] and n_track == N_FRAMES - 1 and n_pub == n_map
    ckpt = os.path.join(str(work / name), "ckpts", f"{N_FRAMES - 1:05d}.npz")
    jleaves, meta = load_in_jax(ckpt, jslam)
    assert list(meta["keyframe_idx_list"]) == jslam.keyframes.frame_idx == [0, 5]
    writer = next(r for r in res[name] if r["writer"])
    with np.load(os.path.join(str(work), f"{name}.rank{writer['rank']}.npz")) as ours:
        leaves = [ours[k] for k in sorted(k for k in ours.files if k.startswith("p"))]
    assert len(jleaves) == len(leaves) == 82
    for a, b in zip(jleaves, leaves):
        np.testing.assert_array_equal(a, b)


def test_split_gt_camera_keeps_the_one_device_map_as_jax_does(split_runs, jax_split):
    """Under GT poses a split 1+1 maps as one device does, bit for bit, in
    the JAX package (against its one-device loose run) and in the port
    (against its one-process strict run, whose map its loose run equals:
    tests/test_torch_async.py)."""
    work, res = split_runs
    for a, b in zip(jax.tree_util.tree_leaves(jax_split["split_gt"][0].params),
                    jax.tree_util.tree_leaves(jax_split["loose_gt"][0].params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    cmp = mh.compare_async(res["split_gt"], str(work / "split_gt"), str(work / "strict_single_gt"))
    assert cmp["equal_to_reference"] and cmp["max_abs_diff_to_reference"] == 0.0, cmp


@pytest.mark.parametrize("k,m", [(2, 1), (1, 2)])
def test_split_with_a_dp_group_per_agent(split_runs, k, m):
    """Two map ranks summing over their group (free), or two track ranks
    (loose, the second replaying the lead's log): every rank's final scene
    bit-equal, the track ranks' trajectories too, each role's logs alike."""
    work, res = split_runs
    runs = res[f"split_{k}_{m}"]
    assert [r["role"] for r in runs] == ["map"] * k + ["track"] * m
    assert [r["writer"] for r in runs] == [False] * k + [True] + [False] * (m - 1)
    cmp = mh.compare_async(runs, str(work / f"split_{k}_{m}"), str(work / "strict_single"))
    assert cmp["replicas_equal"] and cmp["trajectories_equal"] and cmp["logs_replayed"], cmp
    assert cmp["traj_max_diff_to_reference_mm"] < TRAJ_GATE_M * 1e3, cmp
    assert all(r["all_map_losses_finite"] for r in runs[:k]) and np.isfinite(runs[k]["track_losses"]).all()


@pytest.mark.skipif(not _sockets_allowed(), reason="no local sockets")
def test_bench_async_split_records_the_jax_keys(tmp_path, monkeypatch):
    """The harness with ``--split 1,1`` on the CPU at the tiny size: the
    JAX harness's nine reps and summary keys; every rep tracks and maps the
    schedule's frames."""
    from attentive_dfprior_tpu_torch.tools import bench_async

    torch.set_num_threads(1)
    argv = ["--device", "cpu", "--frames", str(N_FRAMES), "--split", "1,1", "--out", str(tmp_path / "bench.json"),
            "--out-root", str(tmp_path / "runs")]
    payload = bench_async.main(argv, overrides=ASYNC_TINY)
    assert json.load(open(tmp_path / "bench.json")) == json.loads(json.dumps(payload))
    assert list(payload["runs"]) == ["strict_warm", "loose", "strict", "strict_dp_warm", "loose_dp_warm",
                                     "loose_split_warm", "strict_dp", "loose_dp", "loose_split"]
    keys = {"sync_method", "parallel", "frames", "wall_s", "n_tracked", "n_mapped", "track_interval_median_s",
            "track_interval_p90_s", "publishes", "publish_skips", "publish_s_total"}
    for tag, rec in payload["runs"].items():
        assert keys <= set(rec), tag
        assert rec["n_tracked"] == N_FRAMES - 1 and rec["n_mapped"] == 3 and rec["wall_s"] > 0, tag
        pubs = rec["publishes"] + rec["publish_skips"]
        assert pubs == (3 if rec["sync_method"] == "loose" else 0), tag
    assert payload["runs"]["loose_split"]["parallel"] == {"enable": True, "split": {"map": 1, "track": 1}}
    assert payload["runs"]["loose_dp"]["parallel"] == {"enable": True, "n_devices": 2}
    s = payload["summary"]
    assert s["speedup_split_vs_strict_dp"] > 0 and s["speedup_split_vs_loose_dp"] > 0 and "split_note" in s
