"""The port's process groups for real: ``torch.distributed`` over gloo on the
CPU, in processes joined over local sockets (skipped where the sandbox
refuses them, as tests/test_multihost.py is).

  - ``attentive_dfprior_tpu_torch.run --multihost --init_only`` on 2 gloo
    processes (``torchrun``'s variables);
  - ``tools/multihost_smoke.py`` phases 1-3 (the JAX ``run.py``'s manual
    variables, a cross-process gather, ``mapping_stage`` on 2 processes
    against one within 1e-4);
  - ``tools/dryrun_multichip.py 2``;
  - a 6-frame strict ``SLAMSystem.run`` on 2 ranks (``multihost_smoke``
    phase 4): replicas bit-equal, trajectory within 5 mm of one process;
  - the flat-bucket all-reduce, the gather and the broadcast on a world of
    one (a ``file://`` store).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLEAN = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "DFPRIOR_COORD", "DFPRIOR_NPROCS",
         "DFPRIOR_PROC_ID")


def _sockets_allowed() -> bool:
    try:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        s.close()
        return True
    except OSError:
        return False


pytestmark = pytest.mark.skipif(not _sockets_allowed(), reason="no local sockets")


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if k not in CLEAN}
    env.update(kw)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_run_multihost_init_only_two_gloo_processes():
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "attentive_dfprior_tpu_torch.run", "configs/Synthetic/room_tracking.yaml",
             "--multihost", "--init_only", "--device", "cpu"],
            cwd=REPO, env=_env(RANK=str(i), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-2000:]
        assert f"multihost: process {i}/2, backend gloo, device cpu" in out


def _smoke(tmp_path, *args):
    out = tmp_path / "smoke.json"
    r = subprocess.run(
        [sys.executable, "-m", "attentive_dfprior_tpu_torch.tools.multihost_smoke", "--out", str(out), *args],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]
    return json.loads(out.read_text())


def test_multihost_smoke_phases_1_to_3(tmp_path):
    rec = _smoke(tmp_path)
    assert rec["ok"] and set(rec["phases"]) == {"runpy_init", "cross_process_gather", "cross_process_mapping_stage"}
    ph3 = rec["phases"]["cross_process_mapping_stage"]
    assert len(ph3["losses_2proc"]) == 3 and ph3["losses_2proc"] != [0.0] * 3


def test_dryrun_multichip_two_ranks():
    r = subprocess.run([sys.executable, "-m", "attentive_dfprior_tpu_torch.tools.dryrun_multichip", "2"],
                       cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "dryrun_multichip: OK on 2 ranks (gloo, cpu)" in r.stdout and "replicas bit-equal" in r.stdout


def test_strict_slam_run_on_two_ranks(tmp_path):
    """6 frames of room_tracking.yaml at the tiny size, parallel.enable on
    2 gloo ranks, in one process and in the one-ulp witness: the ranks end
    bit-equal, within 5 mm of the single run; frame 0's map losses within
    1e-3."""
    rec = _smoke(tmp_path, "--phases", "4", "--frames", "6")
    ph = rec["phases"]["cross_process_slam"]
    assert ph["ok"] and ph["replicas_equal"] and ph["finite"]
    gaps = ph["dp_vs_single"]
    assert gaps["traj_max_diff_mm"] <= 5.0 and gaps["frame0_map_loss_max_rel"] <= 1e-3
    assert all(g["ok"] for g in ph["gates"].values())
    # the witness (one ulp on every grid element) is a run of its own: it parts, and its gap sets no limit here
    wit = ph["witness_vs_single"]
    assert 0.0 < wit["frame0_map_loss_max_rel"] and 10 * wit["frame0_map_loss_max_rel"] < 1e-3
    assert ph["gates"]["frame0_map_loss_max_rel"]["limit"] == 1e-3
    assert ph["n_leaves"] == 82 and ph["n_frame0_iters"] == 10


def test_bucket_collectives_on_a_world_of_one(tmp_path):
    """``RayShards.all_reduce`` (one flat bucket, ``None`` passed through),
    ``gather_rays`` (blocks of unequal length) and ``replicate`` on a real
    gloo group of one process."""
    from attentive_dfprior_tpu_torch.parallel.sharding import RayShards, replicate

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        shards = RayShards(size=1, ranks=(0,), group=dist.group.WORLD)
        a, b = torch.arange(6.0).reshape(2, 3), torch.tensor([2.5])
        out = shards.all_reduce([a, None, b])
        assert out[1] is None and torch.equal(out[0], a) and torch.equal(out[2], b) and out[0].shape == (2, 3)
        three = RayShards(size=3, ranks=(0, 1, 2), group=dist.group.WORLD)
        full = three.gather_rays([torch.ones(3), 2 * torch.ones(2), 3 * torch.ones(2)], 7)
        assert full.tolist() == [1, 1, 1, 2, 2, 3, 3]
        leaves = [torch.ones(2, 2), torch.zeros(3)]
        replicate(leaves, shards)
        assert torch.equal(leaves[0], torch.ones(2, 2)) and torch.equal(leaves[1], torch.zeros(3))
    finally:
        dist.destroy_process_group()
