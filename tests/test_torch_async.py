"""The port's async sync modes (``loose``, ``free``) on the CPU.

At the tiny size of ``tests/test_torch_slam.py:tiny_room_cfg`` (fewer
frames and iterations; the model's widths stay):

  - with ``tracking.gt_camera`` the tracker draws nothing and loop closure
    is off, so the map is a function of the mapper's draws alone: ``loose``
    and ``free`` end with scene leaves and checkpoint arrays ``torch.equal``
    to the strict run's;
  - a ``loose`` run keeps the JAX package's schedule (mapped frames,
    keyframes, event counts; every mapped frame published or skipped), its
    checkpoint loads in the JAX ``load_checkpoint``, its poses stay within
    ``POSE_ATOL_M`` of the port's strict run (the tracker draws from its own
    generator in the async modes, so the poses differ by tracking noise);
  - a published snapshot is isolated from the mapper's leaves;
  - resume into ``loose`` makes progress; a worker crash surfaces in the
    main thread; the ``loose`` staleness gate holds in ``metrics.jsonl``;
  - K2's weight-image cache builds one image per decoder and version when
    two threads ask for it at once.
"""

from __future__ import annotations

import copy
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from attentive_dfprior_tpu.config import default_config_path as j_default_cfg
from attentive_dfprior_tpu.config import load_config as j_load_config
# imported before any test patches ``config.load_config``: run.py binds the loader when first imported
from attentive_dfprior_tpu_torch import run as _run  # noqa: F401
from attentive_dfprior_tpu_torch.slam.system import SLAMSystem
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves
from test_torch_slam import REPO, tiny_room_cfg

N_FRAMES = 7  # tracks 1-6, maps 0, 5 and 6 (the last), keyframes 0 and 5
POSE_ATOL_M = 0.02  # loose vs strict translations; the gap grows with the frame (the constant-speed
# initialisation compounds it) and read 1.04 cm at frame 6 on this config


def async_cfg(sync: str, gt_camera: bool = False):
    cfg = tiny_room_cfg()
    cfg["sync_method"] = sync
    cfg["data"]["n_frames"] = N_FRAMES
    cfg["mapping"].update(iters_first=6, iters=4, BA=False, color_refine=False)
    cfg["tracking"].update(iters=2, gt_camera=gt_camera)
    cfg["meshing"]["resolution"] = 16
    return cfg


def run_port(cfg, out, **kw):
    slam = SLAMSystem(cfg, output=str(out), device="cpu")
    slam.run(**kw)
    records = [json.loads(ln) for ln in open(os.path.join(str(out), "metrics.jsonl"))]
    return slam, records


@pytest.fixture(scope="module")
def strict_gt(tmp_path_factory):
    torch.set_num_threads(1)
    return run_port(async_cfg("strict", gt_camera=True), tmp_path_factory.mktemp("strict_gt"))[0]


@pytest.fixture(scope="module")
def loose_run(tmp_path_factory):
    torch.set_num_threads(1)
    return run_port(async_cfg("loose"), tmp_path_factory.mktemp("loose"))


@pytest.mark.parametrize("sync", ["loose", "free"])
def test_gt_camera_async_equals_strict(strict_gt, tmp_path, sync):
    slam, records = run_port(async_cfg(sync, gt_camera=True), tmp_path)
    for a, b in zip(tree_leaves(slam.params), tree_leaves(strict_gt.params)):
        assert torch.equal(a.detach(), b.detach())
    last = f"{N_FRAMES - 1:05d}.npz"
    ours = np.load(os.path.join(str(tmp_path), "ckpts", last), allow_pickle=True)
    ref = np.load(os.path.join(strict_gt.output, "ckpts", last), allow_pickle=True)
    assert sorted(ours.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    maps = [r for r in records if r["event"] == "map"]
    pubs = [r for r in records if r["event"] in ("publish", "publish_skip")]
    assert [r["idx"] for r in maps] == [0, 5, N_FRAMES - 1] and len(pubs) == len(maps)


def jax_config(cfg, parallel=None):
    """The port's test config ``cfg`` as the JAX package reads it:
    room_tracking.yaml with ``cfg``'s sections, sync method and frame count,
    and ``parallel`` (over the 8 virtual CPU devices of tests/conftest.py)."""
    jcfg = j_load_config(os.path.join(REPO, "configs", "Synthetic", "room_tracking.yaml"), j_default_cfg())
    for k in ("cam", "tracking", "mapping", "tsdf", "rendering", "loop_closure", "pretrained_decoders", "meshing"):
        jcfg[k] = dict(cfg[k])
    jcfg.update(sync_method=cfg["sync_method"], verbose=False)
    jcfg["data"]["n_frames"] = cfg["data"]["n_frames"]
    if parallel is not None:
        jcfg["parallel"] = parallel
    return jcfg


def run_jax(cfg, out, parallel=None):
    """The JAX package's ``SLAMSystem.run`` on ``jax_config(cfg,
    parallel)``, side outputs off (the schedule only: no meshes); the
    system and its ``metrics.jsonl`` records."""
    from attentive_dfprior_tpu.slam.system import SLAMSystem as JSLAMSystem

    jslam = JSLAMSystem(jax_config(cfg, parallel), output=str(out))
    jslam._side_outputs = lambda *a, **k: None
    jslam.run()
    return jslam, [json.loads(ln) for ln in open(os.path.join(str(out), "metrics.jsonl"))]


def schedule(records):
    """An async run's schedule from its ``metrics.jsonl`` records: the
    mapped frames, the counts of maps and tracked frames, and the publishes
    with the skipped ones."""
    ev = [r["event"] for r in records]
    return ([r["idx"] for r in records if r["event"] == "map"], ev.count("map"), ev.count("track"),
            ev.count("publish") + ev.count("publish_skip"))


def load_in_jax(ckpt, jslam):
    """The port's checkpoint ``ckpt`` through the JAX ``load_checkpoint``
    on the scene template of the JAX run ``jslam``: its leaves (numpy) and
    its metadata."""
    from attentive_dfprior_tpu.models.scene import SceneConfig as JSceneConfig
    from attentive_dfprior_tpu.models.scene import init_scene as j_init_scene
    from attentive_dfprior_tpu.utils.logger import load_checkpoint as j_load_checkpoint

    template = j_init_scene(jax.random.PRNGKey(0), JSceneConfig.from_config(jslam.cfg, pretrained_loaded=True))
    jparams, meta = j_load_checkpoint(ckpt, template)
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(jparams)], meta


def test_loose_schedule_matches_jax(loose_run, tmp_path):
    slam, records = loose_run
    jslam, jrecords = run_jax(async_cfg("loose"), tmp_path / "jax")

    assert schedule(records) == schedule(jrecords)
    maps, n_map, _, n_pub = schedule(records)
    assert maps == [0, 5, N_FRAMES - 1] and n_pub == n_map
    assert slam.keyframes.frame_idx == jslam.keyframes.frame_idx == [0, 5]

    ckpt = os.path.join(slam.output, "ckpts", f"{N_FRAMES - 1:05d}.npz")
    jleaves, meta = load_in_jax(ckpt, jslam)
    assert meta["idx"] == N_FRAMES - 1 and list(meta["keyframe_idx_list"]) == [0, 5]
    for a, b in zip(jleaves, tree_leaves(slam.params)):
        np.testing.assert_array_equal(a, b.detach().numpy())

    strict, _ = run_port(async_cfg("strict"), tmp_path / "strict")
    est, ref = slam.estimate_c2w_list[:N_FRAMES], strict.estimate_c2w_list[:N_FRAMES]
    assert np.isfinite(est).all()
    np.testing.assert_allclose(est[:, :3, 3], ref[:, :3, 3], atol=POSE_ATOL_M)


def test_loose_staleness_invariant(loose_run):
    """Every ``track`` at idx comes after a ``map`` of a frame at least
    idx - max_lag in ``metrics.jsonl``."""
    slam, records = loose_run
    max_lag = slam.every_frame + slam.every_frame // 2
    mapped = -1
    tracked = 0
    for r in records:
        if r["event"] == "map":
            mapped = max(mapped, r["idx"])
        elif r["event"] == "track":
            assert mapped >= r["idx"] - max_lag, (r, mapped)
            tracked += 1
    assert tracked == N_FRAMES - 1


def test_snapshot_isolation(tmp_path):
    torch.set_num_threads(1)
    slam = SLAMSystem(async_cfg("loose"), output=str(tmp_path), device="cpu")
    frames = [slam.dataset[i] for i in range(2)]
    _, color, depth, gt = frames[0]
    slam.estimate_c2w_list[0] = gt
    slam._map_frame(0, color, depth, gt, gt, first=True)
    snap = slam._snapshot_for_tracker()
    held = [t.clone() for t in tree_leaves(snap)]
    live = {t.untyped_storage().data_ptr() for t in tree_leaves(slam.params)}
    assert not any(t.untyped_storage().data_ptr() in live for t in tree_leaves(snap))
    assert not any(t.requires_grad for t in tree_leaves(snap))
    assert all(t.requires_grad for t in tree_leaves(slam.params))  # the mapper's leaves

    # a mapping step moves the mapper's leaves, not the snapshot's
    before = [t.detach().clone() for t in tree_leaves(slam.params)]
    slam._map_frame(0, color, depth, gt, gt, first=False)
    assert any(not torch.equal(a, b.detach()) for a, b in zip(before, tree_leaves(slam.params)))
    for a, b in zip(held, tree_leaves(snap)):
        assert torch.equal(a, b)

    # a tracker frame on the snapshot writes no .grad anywhere
    grads = [t.grad for t in tree_leaves(slam.params)]
    _, color1, depth1, gt1 = frames[1]
    slam._track_frame(1, color1, depth1, gt1, params=snap)
    assert np.isfinite(slam.estimate_c2w_list[1]).all()
    assert all(t.grad is g for t, g in zip(tree_leaves(slam.params), grads))
    assert all(t.grad is None for t in tree_leaves(snap))
    for a, b in zip(held, tree_leaves(snap)):
        assert torch.equal(a, b)


def test_resume_into_loose_makes_progress(tmp_path):
    torch.set_num_threads(1)
    first, _ = run_port(async_cfg("strict"), tmp_path / "first", end_idx=5)
    ckpt = os.path.join(first.output, "ckpts", "00004.npz")
    assert os.path.exists(ckpt)
    slam = SLAMSystem(async_cfg("loose"), output=str(tmp_path / "resumed"), device="cpu")
    assert slam.resume(ckpt) == 5
    est = slam.run(start_idx=5)
    records = [json.loads(ln) for ln in open(os.path.join(slam.output, "metrics.jsonl"))]
    assert [r["idx"] for r in records if r["event"] == "track"] == [5, 6]
    assert [r["idx"] for r in records if r["event"] == "map"] == [5, 6]
    assert np.isfinite(est[:N_FRAMES]).all() and slam.last_idx == N_FRAMES - 1
    np.testing.assert_array_equal(est[:5], first.estimate_c2w_list[:5])
    assert os.path.exists(os.path.join(slam.output, "ckpts", f"{N_FRAMES - 1:05d}.npz"))


@pytest.mark.parametrize("sync", ["loose", "free"])
def test_worker_crash_surfaces(tmp_path, monkeypatch, sync):
    slam = SLAMSystem(async_cfg(sync), output=str(tmp_path), device="cpu")

    class Boom(RuntimeError):
        pass

    def crash(*a, **k):
        raise Boom("mapper failed")

    monkeypatch.setattr(slam, "_map_frame", crash)
    with pytest.raises(Boom, match="mapper failed"):
        slam.run()
    assert not any(t.name == "mapper" and t.is_alive() for t in threading.enumerate())


def test_k2_cache_under_two_threads():
    from attentive_dfprior_tpu_torch.models.decoders import init_mlp_decoder
    from attentive_dfprior_tpu_torch.ops.cuda.decoder_kernel import _TcCache

    decoders = [init_mlp_decoder(torch.Generator().manual_seed(s), c_dim=c, color=color)
                for s, (c, color) in enumerate([(32, False), (64, False), (32, True)])]
    cache = _TcCache()
    barrier = threading.Barrier(2)
    images, errors = [[], []], []

    def ask(slot):
        try:
            for rnd in range(2):
                barrier.wait()
                if rnd == 1 and slot == 0:
                    with torch.no_grad():  # a new version of decoder 0, as an Adam step makes
                        decoders[0]["out"]["w"].add_(1.0)
                barrier.wait()
                images[slot].append([cache.get(d) for d in decoders for _ in range(3)])
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert cache.builds == 4  # three decoders, then decoder 0's second version
    for rnd in range(2):
        a, b = images[0][rnd], images[1][rnd]
        assert all(x is y for x, y in zip(a, b))  # both threads got the one image
    assert images[0][1][0] is not images[0][0][0] and images[0][1][3] is images[0][0][3]


def test_bench_async_records_strict_and_loose(tmp_path, monkeypatch):
    """The harness's three reps on the CPU at the tiny size (the config
    loader returns ``async_cfg``): every record key, the counts the
    schedule gives, one publish or skip per map in the loose rep."""
    from attentive_dfprior_tpu_torch import config
    from attentive_dfprior_tpu_torch.tools import bench_async

    torch.set_num_threads(1)
    tiny = async_cfg("strict")
    monkeypatch.setattr(config, "load_config", lambda *a, **k: copy.deepcopy(tiny))
    out = tmp_path / "bench.json"
    payload = bench_async.main(["--device", "cpu", "--frames", str(N_FRAMES), "--out", str(out),
                                "--out-root", str(tmp_path / "runs")])
    assert json.load(open(out)) == json.loads(json.dumps(payload))
    assert list(payload["runs"]) == ["strict_warm", "loose", "strict"]
    for tag, rec in payload["runs"].items():
        assert rec["sync_method"] == ("loose" if tag == "loose" else "strict")
        assert rec["n_tracked"] == N_FRAMES - 1 and rec["n_mapped"] == 3 and rec["wall_s"] > 0
        assert rec["track_interval_median_s"] <= rec["track_interval_p90_s"]
        pubs = rec["publishes"] + rec["publish_skips"]
        assert pubs == (3 if tag == "loose" else 0) and rec["publish_s_total"] >= 0
    assert payload["summary"]["device"] == "cpu" and payload["summary"]["wall_strict_over_loose"] > 0
