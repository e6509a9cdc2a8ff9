"""Multi-process smoke of the port's ray-axis data parallelism.

    python -m attentive_dfprior_tpu_torch.tools.multihost_smoke [--phases 123] [--frames 21] [--out F.json]

The counterpart of the JAX package's ``scripts/multihost_smoke.py``. Every
process is a child started here, joined to the others over a local port;
each phase starts its own:

  1. two ``attentive_dfprior_tpu_torch.run <cfg> --multihost --init_only``
     processes joined through the JAX ``run.py``'s manual variables
     (``DFPRIOR_COORD`` / ``DFPRIOR_NPROCS`` / ``DFPRIOR_PROC_ID``): the
     production entry path; each prints ``multihost: process i/2``;
  2. two workers all-reduce a ray-loss vector across the processes
     (``RayShards.gather_rays`` of one 4-ray block each): the tracker's
     gather, whose sum must be 12;
  3. the production ``mapping_stage`` (3 colour-stage iterations on the
     tiny scene of ``tools/dryrun_multichip.py``) on 2 processes against
     one process: per-iteration losses within 1e-4 relative;
  4. (only on request) ``SLAMSystem.run`` on 2 processes against one:
     ``configs/Synthetic/room_tracking.yaml`` at a 24x32 camera (8 + 4
     samples, a 0.16 m prior, 10 mapping and 4 tracking iterations, loop
     closure off) over ``--frames`` frames, with ``parallel.enable``, and
     a one-process witness: the ranks' final scenes and trajectories equal
     bit for bit, and ``compare_slam``'s gates (at this depth the witness
     parts by far less than the limits, which then hold as they are: the
     trajectory within 5 mm of the single run, frame 0's per-iteration map
     losses within 1e-3 relative), every loss finite.

The witness is the single run again with every grid element moved by one
ulp (``slam_worker``'s ``perturb_ulp``). Where a
run is deep enough for the map's optimization to amplify rounding, the
witness parts from the single run as a dp run does (whose one difference
is the order of two partial sums); a dp run is then held to within
WITNESS_FACTOR times the witness's gap, and never tighter than the
absolute limits. A defect of the reduced step (a gradient summed wrong, a
cell the lazy Adam picks on one side only) would part the runs from the
first iterations, which stay held at MAP_LOSS_RTOL.

Every worker runs on the CPU over gloo. Writes the record to ``--out`` when
given; prints a summary as the last line; exits 0 when every phase passed.
The SLAM worker (``slam_worker``, started with ``start`` / ``finish``) is
also the one ``chip_smoke.py`` phases 15 and 16 run on the card, as two
gloo ranks on ``cuda:0`` (NCCL refuses two ranks on one device): its spec
takes ``sync`` and ``split`` for the async agents across processes, and its
result carries the rank's role and the schedule's decision log
(``compare_async`` holds the ranks of one such run to each other).
``bench_worker`` is one rep of ``tools/bench_async.py`` on the group.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from attentive_dfprior_tpu_torch.tools.dryrun_multichip import TINY_CAM, free_port, tiny_frames, tiny_scene

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ROOM_TRACKING = os.path.join("configs", "Synthetic", "room_tracking.yaml")  # relative to the repo
TRAJ_GATE_M = 5e-3  # the JAX smoke's 5 mm (scripts/multihost_smoke.py:29-31)
MAP_LOSS_RTOL = 1e-3  # frame 0's per-iteration map losses, dp against one process
MAP_AGREE_ITERS = 30  # frame 0's first iterations, held at MAP_LOSS_RTOL whatever a witness reads
WITNESS_FACTOR = 10.0  # dp may part from one process by this many times what a one-ulp witness parts
STAGE_LOSS_RTOL = 1e-4  # phase 3, as the JAX smoke
TINY_SLAM = [
    "cam.H=24", "cam.W=32", "cam.fx=24.0", "cam.fy=24.0", "cam.cx=15.5", "cam.cy=11.5",
    "tracking.ignore_edge_W=4", "tracking.ignore_edge_H=4", "tracking.pixels=40", "tracking.iters=4",
    "mapping.iters_first=10", "mapping.iters=10", "mapping.pixels=60", "tsdf.voxel_size=0.16",
    "rendering.N_samples=8", "rendering.N_surface=4", "loop_closure.enable=False",
    "loop_closure.final_refine=False", "meshing.resolution=32", "meshing.eval_rec=False",
]
TAG = "SMOKE_RESULT "  # prefix of a worker's result line


def _child_env(rank: int, world: int, port: int, extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    env.update(extra or {})
    return env


def start(worker: str, spec: Dict[str, Any], world: int, extra_env: Optional[Dict[str, str]] = None,
          cwd: str = REPO):
    """Start ``worker`` in ``world`` child processes joined over a local
    port, or in one process with no group when ``world`` is 0, in the
    working directory ``cwd``; returns the children for ``finish``."""
    port = free_port()
    procs = []
    for rank in range(max(world, 1)):
        env = _child_env(rank, world, port, extra_env) if world else dict(os.environ, **(extra_env or {}))
        if not world:
            for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
                env.pop(k, None)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)  # from any cwd
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "attentive_dfprior_tpu_torch.tools.multihost_smoke", "--worker", worker,
             "--spec", json.dumps(spec)],
            cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    return worker, procs


def finish(started, timeout: float = 900.0) -> List[Dict[str, Any]]:
    """Wait for the children of ``start``; returns each child's result (its
    ``TAG`` line) in rank order, raising with their output if one fails.
    Every child is stopped before it returns."""
    worker, procs = started
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, out in zip(procs, outs):
        lines = [ln for ln in out.splitlines() if ln.startswith(TAG)]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"worker {worker} exited {p.returncode}:\n" + "\n---\n".join(o[-3000:] for o in outs))
        results.append(json.loads(lines[-1][len(TAG):]))
    return results


def launch(worker: str, spec: Dict[str, Any], world: int, extra_env: Optional[Dict[str, str]] = None,
           timeout: float = 900.0) -> List[Dict[str, Any]]:
    """``start`` then ``finish``."""
    return finish(start(worker, spec, world, extra_env), timeout)


# ---------------------------------------------------------------- workers


def _join(spec) -> Optional[Any]:
    """Join the group when the launcher's environment names one; returns
    the dp group (``mesh_from_config``) or None."""
    from attentive_dfprior_tpu_torch.parallel.sharding import init_distributed, mesh_from_config

    if os.environ.get("WORLD_SIZE"):
        init_distributed(backend=spec.get("backend"), device=spec["device"])
    return mesh_from_config({"parallel": {"enable": True}})


def gather_worker(spec) -> Dict[str, Any]:
    """Phase 2: each rank's 4-ray block of an 8-ray loss vector, gathered
    and summed across the processes."""
    shards = _join(spec)
    rank = dist.get_rank()
    local = torch.full((4,), float(rank + 1), device=spec["device"])
    full = shards.gather_rays([local], 4 * shards.size)
    return {"rank": rank, "sum": float(full.sum()), "vector": full.tolist()}


def mapping_worker(spec) -> Dict[str, Any]:
    """Phase 3: the production ``mapping_stage`` on the tiny scene, on the
    group when there is one."""
    from attentive_dfprior_tpu_torch.ops.adam import adam_init
    from attentive_dfprior_tpu_torch.parallel.sharding import replicate
    from attentive_dfprior_tpu_torch.render.renderer import RenderConfig
    from attentive_dfprior_tpu_torch.slam.mapper import StageLRs, mapping_stage
    from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

    shards = _join(spec)
    dev = torch.device(spec["device"])
    params, tsdf, tsdf_bnds, bound = tiny_scene(dev)
    replicate(tree_leaves(params), shards)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    color, depth, c2w = tiny_frames(2, dev, seed=3)
    losses = mapping_stage(
        params, adam_init(params), color, depth, c2w, None, tsdf, tsdf_bnds, bound, 3, [0.0] * 3,
        StageLRs(5e-3, 5e-3, 5e-3, 5e-3, 5e-3), "color", 16, TINY_CAM, RenderConfig(N_samples=8, N_surface=4),
        (False, False), 0.2, generator=torch.Generator(device=dev).manual_seed(4), shards=shards,
    )
    return {"rank": dist.get_rank() if dist.is_initialized() else 0, "losses": losses.tolist()}


def slam_worker(spec) -> Dict[str, Any]:
    """``SLAMSystem.run`` on ``spec["config"]`` with ``spec["overrides"]``
    (``--set`` syntax) to ``spec["end_idx"]``, on the group when there is
    one. ``spec["sync"]`` sets ``sync_method``, and ``spec["split"]`` ({map: k,
    track: m}) ``parallel.split``. With ``spec["perturb_ulp"]`` every element
    of the feature grids is moved one ulp up (``torch.nextafter``) before the
    run (the witness of ``compare_slam``). With ``spec["crash_rank"]`` that
    rank's mapper raises at its first map job. Writes the final scene leaves
    and the trajectory to ``<spec["record"]>.rank<r>.npz``; returns the
    rank's role, both agents' step modes (``SLAMSystem.step_mode``: graph
    where an agent is alone in its group or on NCCL, eager on gloo), the
    schedule's decision log as the rank appended or replayed it, frame 0's
    per-iteration map losses, the tracking and mapping losses and the map /
    publish events of ``metrics.jsonl`` (the writer's), every kernel's
    launches, and seconds by part."""
    from attentive_dfprior_tpu_torch.config import default_config_path, load_config
    from attentive_dfprior_tpu_torch.ops.cuda.build import port_kernels
    from attentive_dfprior_tpu_torch.run import apply_overrides
    from attentive_dfprior_tpu_torch.slam import tracker as tracker_mod
    from attentive_dfprior_tpu_torch.slam.mapper import GRID_KEYS
    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem
    from attentive_dfprior_tpu_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    _join(spec)
    rank = dist.get_rank() if dist.is_initialized() else 0
    cfg = load_config(spec["config"], default_config_path())
    apply_overrides(cfg, spec["overrides"])
    cfg["seed"] = 0
    if spec.get("sync"):
        cfg["sync_method"] = spec["sync"]
    if spec.get("split"):
        cfg["parallel"] = dict(cfg.get("parallel") or {}, enable=True, split=dict(spec["split"]))
    kernels = port_kernels()
    for k in kernels:
        k.launches = 0
    slam = SLAMSystem(cfg, output=spec["output"], device=spec["device"])
    if spec.get("perturb_ulp"):
        with torch.no_grad():
            for k in GRID_KEYS:
                slam.params[k].copy_(torch.nextafter(slam.params[k], torch.full_like(slam.params[k], float("inf"))))
    frame_losses: List[List[float]] = []
    optimize_map = slam.mapper.optimize_map

    def recorded(*a, **kw):
        out = optimize_map(*a, **kw)
        frame_losses.append(torch.cat(list(out[3].values())).tolist())
        return out

    slam.mapper.optimize_map = recorded
    if spec.get("crash_rank") == rank:
        def crash(*a, **kw):
            raise RuntimeError(f"mapper failed on rank {rank}")

        slam._map_frame = crash
    # the tracker's per-iteration losses, and the trajectory the final refine starts from
    track_losses: List[List[float]] = []
    track_frame = tracker_mod.track_frame

    def recorded_track(*a, **kw):
        out = track_frame(*a, **kw)
        track_losses.append(out[1].tolist())
        return out

    tracker_mod.track_frame = recorded_track
    n = spec["end_idx"]
    before_refine = {}
    final_refine = slam.loop_closer.final_refine

    def recorded_refine(dataset, est, *a, **kw):
        before_refine["traj"] = est[:n].copy()
        return final_refine(dataset, est, *a, **kw)

    slam.loop_closer.final_refine = recorded_refine
    t_run = time.perf_counter()
    try:
        est = slam.run(end_idx=n)
    finally:
        tracker_mod.track_frame = track_frame
    if slam.device.type == "cuda":
        torch.cuda.synchronize(slam.device)
    run_s = time.perf_counter() - t_run
    leaves = [t.detach().cpu().numpy() for t in tree_leaves(slam.params)]
    np.savez(f"{spec['record']}.rank{rank}.npz", traj=est[:n], traj_before_refine=before_refine.get("traj", est[:n]),
             gt=slam.gt_c2w_list[:n],
             **{f"p{i:04d}": v for i, v in enumerate(leaves)})
    events = []
    if slam.is_writer:
        with open(os.path.join(spec["output"], "metrics.jsonl")) as f:
            events = [json.loads(ln) for ln in f]
    return {
        "rank": rank, "world": dist.get_world_size() if dist.is_initialized() else 1,
        "device": str(slam.device), "dp": slam.shards is not None, "role": slam.role, "step_mode": slam.step_mode,
        "writer": slam.is_writer, "schedule": slam.schedule_records,
        "schedule_events": [[e["event"], e["idx"]] for e in events
                            if e["event"] in ("map", "publish", "publish_skip", "track")],
        "map_losses_frame0": frame_losses[0] if frame_losses else [],
        "all_map_losses_finite": bool(all(np.isfinite(v).all() for v in frame_losses)),
        "track_losses": [e["loss"] for e in events if e["event"] == "track"],
        "track_iter_losses": track_losses,
        "events": sorted({e["event"] for e in events}),
        "launches": {k.name: k.launches for k in kernels},
        "seconds": {"total": time.perf_counter() - t0, "run": run_s, **slam.timings},
    }


def bench_worker(spec) -> Dict[str, Any]:
    """One rep of ``tools/bench_async.py`` (``run_mode``) on the group."""
    from attentive_dfprior_tpu_torch.tools.bench_async import run_mode

    _join(spec)
    rank = dist.get_rank() if dist.is_initialized() else 0
    return run_mode(spec["sync"], spec["frames"], os.path.join(spec["output"], f"rank{rank}"), spec["device"],
                    parallel=spec.get("parallel"), overrides=spec.get("overrides", ()))


WORKERS = {"gather": gather_worker, "mapping": mapping_worker, "slam": slam_worker, "bench": bench_worker}


def _worker_main(name: str, spec: Dict[str, Any]) -> None:
    # torch's CPU threads: spec["threads"], else on the CPU the host's cores shared by the ranks
    if spec.get("threads"):
        torch.set_num_threads(int(spec["threads"]))
    elif torch.device(spec["device"]).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // max(1, int(os.environ.get("WORLD_SIZE", "1")))))
    try:
        out = WORKERS[name](spec)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(TAG + json.dumps(out), flush=True)


# ----------------------------------------------------------------- checks


def _gaps(a, b, run_a: Dict[str, Any], run_b: Dict[str, Any]) -> Dict[str, Any]:
    """How far run ``a`` parts from run ``b`` (their ``.npz`` records and
    result lines): translation gaps by frame before and after the final
    refine, and frame 0's relative map-loss gaps."""
    by_frame = {k: np.linalg.norm(a[k][:, :3, 3] - b[k][:, :3, 3], axis=-1) * 1e3
                for k in ("traj_before_refine", "traj")}
    la, lb = np.asarray(run_a["map_losses_frame0"]), np.asarray(run_b["map_losses_frame0"])
    rel = np.abs(la - lb) / np.maximum(np.abs(lb), 1e-12) if la.shape == lb.shape and la.size else np.full(1, np.inf)
    return {
        "frame0_map_loss_max_rel": float(rel.max()),
        "frame0_first_iters_max_rel": float(rel[:MAP_AGREE_ITERS].max()),
        "frame0_rel_per_10_iters": [float(rel[i:i + 10].max()) for i in range(0, len(rel), 10)],
        "tracked_max_diff_mm": float(by_frame["traj_before_refine"].max()),
        "traj_max_diff_mm": float(by_frame["traj"].max()),
        "before_refine_diff_mm_by_frame": [round(float(v), 4) for v in by_frame["traj_before_refine"]],
        "traj_diff_mm_by_frame": [round(float(v), 4) for v in by_frame["traj"]],
    }


def compare_slam(dp: List[Dict[str, Any]], single: Dict[str, Any], record: str,
                 witness: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The dp ranks against each other (bit for bit) and against the single
    run; with ``witness`` (the single run moved by one ulp, its record at
    ``<record>.witness.rank0.npz``) the witness against the single run too.

    Gates: the ranks equal; every loss finite; frame 0's first
    MAP_AGREE_ITERS map losses within MAP_LOSS_RTOL; and frame 0's map
    losses, the tracked and the refined trajectory each within
    max(absolute limit, WITNESS_FACTOR x the witness's gap) of the single
    run (the absolute limits, MAP_LOSS_RTOL and TRAJ_GATE_M, alone without
    a witness). Returns the readings, each gate and ``ok``."""
    arrays = [np.load(f"{record}.dp.rank{r['rank']}.npz") for r in dp]
    one = np.load(f"{record}.single.rank0.npz")
    keys = sorted(arrays[0].files)
    equal = all(sorted(a.files) == keys and all(np.array_equal(a[k], arrays[0][k]) for k in keys) for a in arrays[1:])
    runs = [("dp", arrays[0]), ("single", one)]
    gaps = _gaps(arrays[0], one, dp[0], single)
    wgaps = None
    if witness is not None:
        wit = np.load(f"{record}.witness.rank0.npz")
        runs.append(("witness", wit))
        wgaps = _gaps(wit, one, witness, single)
    # each run's unaligned translation error against the ground truth, RMSE, before and after the refine
    ate_mm = {f"{name} {k}": float(np.sqrt(np.mean(np.sum((a[k][:, :3, 3] - a["gt"][:, :3, 3]) ** 2, -1)))) * 1e3
              for name, a in runs for k in ("traj_before_refine", "traj")}
    finite = all(r["all_map_losses_finite"] and np.isfinite(r["track_losses"]).all()
                 for r in dp + [single] + ([witness] if witness else []))
    gates = {"frame0_first_iters_max_rel": {"dp": gaps["frame0_first_iters_max_rel"], "witness": None,
                                            "limit": MAP_LOSS_RTOL}}
    for key, floor in (("frame0_map_loss_max_rel", MAP_LOSS_RTOL), ("tracked_max_diff_mm", TRAJ_GATE_M * 1e3),
                       ("traj_max_diff_mm", TRAJ_GATE_M * 1e3)):
        w = wgaps[key] if wgaps else None
        gates[key] = {"dp": gaps[key], "witness": w, "limit": max(floor, WITNESS_FACTOR * (w or 0.0))}
    for g in gates.values():
        g["ok"] = bool(g["dp"] <= g["limit"])
    ok = equal and finite and all(r["dp"] for r in dp) and all(g["ok"] for g in gates.values())
    return {"ok": bool(ok), "replicas_equal": bool(equal), "n_leaves": sum(k.startswith("p") for k in keys),
            "finite": bool(finite), "n_frame0_iters": len(dp[0]["map_losses_frame0"]), "gates": gates,
            "dp_vs_single": gaps, "witness_vs_single": wgaps,
            "ate_vs_gt_mm": {k: round(v, 3) for k, v in ate_mm.items()}}


def compare_async(runs: List[Dict[str, Any]], record: str, reference: Optional[str] = None) -> Dict[str, Any]:
    """The ranks of one loose / free run (``slam_worker``'s results and
    ``.npz`` records under ``record``) against each other: every rank's
    final scene leaves equal bit for bit, the trajectories of the ranks
    that track equal, and each rank's decision log equal to that of the
    first rank of its role (a follower's is a replay of the lead's). With
    ``reference`` (another run's record) every rank's leaves against its
    rank 0's: ``equal_to_reference`` and the largest difference."""
    arrays = {r["rank"]: np.load(f"{record}.rank{r['rank']}.npz") for r in runs}
    first = arrays[runs[0]["rank"]]
    leaves = sorted(k for k in first.files if k.startswith("p"))

    def max_diff(a, b) -> float:
        if sorted(a.files) != sorted(b.files):
            return float("inf")
        return max(float(np.max(np.abs(a[k] - b[k]), initial=0.0)) for k in leaves)

    trackers = [r for r in runs if r["role"] != "map"]
    writer = next(r for r in runs if r["writer"])
    by_role: Dict[str, List[Dict[str, Any]]] = {}
    for r in runs:
        by_role.setdefault(r["role"], []).append(r)
    out = {
        "roles": {str(r["rank"]): r["role"] for r in runs},
        "replicas_equal": all(max_diff(a, first) == 0.0 for a in arrays.values()),
        "trajectories_equal": all(np.array_equal(arrays[r["rank"]]["traj"], arrays[writer["rank"]]["traj"])
                                  for r in trackers),
        "logs_replayed": all(r["schedule"] == rs[0]["schedule"] for rs in by_role.values() for r in rs),
        "n_log_records": len(writer["schedule"]),
        "n_leaves": len(leaves),
    }
    if reference is not None:
        ref = np.load(f"{reference}.rank0.npz")
        diffs = [max_diff(a, ref) for a in arrays.values()]
        out["equal_to_reference"] = all(d == 0.0 for d in diffs)
        out["max_abs_diff_to_reference"] = max(diffs)
        dt = np.linalg.norm(arrays[writer["rank"]]["traj"][:, :3, 3] - ref["traj"][:, :3, 3], axis=-1)
        out["traj_max_diff_to_reference_mm"] = float(dt.max()) * 1e3
    return out


def run_phases(phases: str, frames: int, workdir: str) -> Dict[str, Any]:
    record: Dict[str, Any] = {"phases": {}}
    base = {"device": "cpu"}
    if "1" in phases:
        port = free_port()
        procs = []
        for i in range(2):
            env = dict(os.environ, DFPRIOR_COORD=f"127.0.0.1:{port}", DFPRIOR_NPROCS="2", DFPRIOR_PROC_ID=str(i))
            for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
                env.pop(k, None)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "attentive_dfprior_tpu_torch.run",
                 os.path.join("configs", "Synthetic", "room.yaml"), "--multihost", "--init_only", "--device", "cpu"],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        outs = []
        try:
            outs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        lines = [[ln for ln in o.splitlines() if ln.startswith("multihost:")] for o in outs]
        ok = all(p.returncode == 0 for p in procs) and all(
            any(ln.startswith(f"multihost: process {i}/2, backend gloo") for ln in lines[i]) for i in range(2))
        record["phases"]["runpy_init"] = {"ok": ok, "stdout": lines}
        print(f"[phase 1 run --multihost --init_only x2] ok={ok} {lines}", flush=True)
    if "2" in phases:
        res = launch("gather", base, 2, timeout=300)
        ok = all(r["sum"] == 12.0 for r in res)
        record["phases"]["cross_process_gather"] = {"ok": ok, "sums": [r["sum"] for r in res]}
        print(f"[phase 2 cross-process gather of a ray-loss vector] ok={ok} sums={[r['sum'] for r in res]}", flush=True)
    if "3" in phases:
        multi = launch("mapping", base, 2)
        single = launch("mapping", base, 0)[0]
        a, b = np.asarray(multi[0]["losses"]), np.asarray(single["losses"])
        ok = a.shape == b.shape == (3,) and bool(np.all(np.abs(a - b) <= STAGE_LOSS_RTOL * np.maximum(1.0, np.abs(b))))
        ok = ok and multi[0]["losses"] == multi[1]["losses"]
        record["phases"]["cross_process_mapping_stage"] = {"ok": ok, "losses_2proc": multi[0]["losses"],
                                                           "losses_1proc": single["losses"]}
        print(f"[phase 3 mapping_stage on 2 processes] ok={ok} 2proc={a.tolist()} 1proc={b.tolist()}", flush=True)
    if "4" in phases:
        rec = os.path.join(workdir, "slam")
        overrides = TINY_SLAM + [f"data.n_frames={frames}", "parallel.enable=True"]
        spec = dict(base, config=ROOM_TRACKING, overrides=overrides, end_idx=frames)
        dp = launch("slam", dict(spec, output=os.path.join(workdir, "dp"), record=rec + ".dp"), 2, timeout=1800)
        single, witness = (
            launch("slam", dict(spec, output=os.path.join(workdir, name), record=f"{rec}.{name}",
                                perturb_ulp=name == "witness"), 0, timeout=1800)[0]
            for name in ("single", "witness")
        )
        cmp = compare_slam(dp, single, rec, witness)
        record["phases"]["cross_process_slam"] = dict(cmp, n_frames=frames)
        print(f"[phase 4 SLAMSystem.run on 2 processes, {frames} frames] {json.dumps(cmp)}", flush=True)
    record["ok"] = all(p["ok"] for p in record["phases"].values())
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="123", help="phases to run; 4 (SLAMSystem.run x 2 processes) on request")
    ap.add_argument("--frames", type=int, default=21, help="phase 4's frames")
    ap.add_argument("--out", default=None, help="write the record here")
    ap.add_argument("--worker", default=None, choices=sorted(WORKERS), help=argparse.SUPPRESS)
    ap.add_argument("--spec", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker_main(args.worker, json.loads(args.spec))
        return
    with tempfile.TemporaryDirectory(prefix="multihost_smoke_") as workdir:
        record = run_phases(args.phases, args.frames, workdir)
    record["when"] = time.strftime("%Y-%m-%d %H:%M:%S")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"multihost_smoke": record["ok"], "phases": {k: v["ok"] for k, v in record["phases"].items()}}))
    sys.exit(0 if record["ok"] else 1)


if __name__ == "__main__":
    main()
