"""Strict against loose, on one device and across ranks: the port of
``scripts/bench_async.py``.

    python -m attentive_dfprior_tpu_torch.tools.bench_async [--frames 20]
        [--device cuda|cpu] [--split m,t] [--out PATH] [--out-root DIR]

Runs the same short ``configs/Synthetic/room_tracking.yaml`` workload
(``data.n_frames`` set to ``--frames``, seed 0, checkpoints and meshes off)
as the JAX harness's reps: ``strict_warm``,
``loose`` and ``strict`` in this process (the first strict rep pays the
one-off costs, kernel builds and the frames rendered on the host, so
compare the second strict rep with the loose one); with ``--split m,t``
also ``strict_dp_warm``, ``loose_dp_warm``, ``loose_split_warm``,
``strict_dp``, ``loose_dp`` and ``loose_split``, each as ``m + t``
processes through ``tools/multihost_smoke.py``'s ``start`` / ``finish``
(``parallel.enable`` on ``m + t`` ranks, then ``parallel.split: {map: m,
track: t}``; every topology's warm rep first), in a working directory
holding the workload's prior, built once (``prior_workdir``). For each rep
it reads the
per-event wall-clock stamps in ``metrics.jsonl`` (the writer's): wall
seconds of ``run()``, frames tracked and mapped, the median and 90th
percentile of the interval between tracked frames, and the publishes,
skipped publishes and seconds spent publishing.

On the card the loose rep's mapper runs on its own thread and CUDA stream
(``slam/system.py:_run_async``), so its kernels may overlap the tracker's;
whether that shortens the run is what the record says. The ranks of the dp
and split reps join over gloo: on one card they all run on ``cuda:0``
(NCCL refuses two ranks on one device) and time-slice it, so those reps
show the schedule's cost, not a speed-up; the record says so
(``split_note``). Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from attentive_dfprior_tpu_torch.utils.device import card_name_and_power

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "Synthetic", "room_tracking.yaml")
REPS = (("strict_warm", "strict"), ("loose", "loose"), ("strict", "strict"))
# the reps across ranks, each topology's warm rep first (scripts/bench_async.py:156-165)
RANK_REPS = (("strict_dp_warm", "strict", "dp"), ("loose_dp_warm", "loose", "dp"),
             ("loose_split_warm", "loose", "split"), ("strict_dp", "strict", "dp"),
             ("loose_dp", "loose", "dp"), ("loose_split", "loose", "split"))


def run_mode(sync: str, frames: int, out: str, device: str, parallel: Optional[Dict[str, Any]] = None,
             overrides: Sequence[str] = ()) -> Dict[str, Any]:
    """One rep: a fresh SLAMSystem on the workload under ``sync`` (with the
    ``parallel`` config section, on the process group this process joined);
    its record, read from the writer's ``metrics.jsonl`` (``{"writer":
    False}`` and the rest below on another rank), with the rank and both
    agents' step modes (``SLAMSystem.step_mode``)."""
    from attentive_dfprior_tpu_torch import config
    from attentive_dfprior_tpu_torch.run import apply_overrides
    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem

    cfg = config.load_config(CONFIG, config.default_config_path())
    apply_overrides(cfg, list(overrides))
    cfg["seed"] = 0
    cfg["sync_method"] = sync
    cfg["data"]["n_frames"] = frames
    if parallel is not None:
        cfg["parallel"] = parallel
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    np.random.seed(0)
    torch.manual_seed(0)
    slam = SLAMSystem(cfg, output=out, device=device)
    slam._side_outputs = lambda *a, **k: None  # no checkpoints or meshes
    t0 = time.perf_counter()
    slam.run()
    if slam.device.type == "cuda":
        torch.cuda.synchronize(slam.device)
    wall = time.perf_counter() - t0
    rank = {"rank": slam.rank, "step_mode": slam.step_mode}
    if not slam.is_writer:
        return {"writer": False, **rank}

    events = [json.loads(ln) for ln in open(os.path.join(out, "metrics.jsonl"))]
    tracks = [e for e in events if e["event"] == "track"]
    pubs = [e for e in events if e["event"] == "publish"]
    iv = np.diff([e["t"] for e in tracks]) if len(tracks) > 1 else np.zeros(0)
    return {
        "writer": True,
        **rank,
        "sync_method": sync,
        "parallel": parallel,
        "frames": frames,
        "wall_s": wall,
        "n_tracked": len(tracks),
        "n_mapped": sum(e["event"] == "map" for e in events),
        "track_interval_median_s": float(np.median(iv)) if len(iv) else None,
        "track_interval_p90_s": float(np.percentile(iv, 90)) if len(iv) else None,
        "publishes": len(pubs),
        "publish_skips": sum(e["event"] == "publish_skip" for e in events),
        "publish_s_total": float(sum(e["publish_s"] for e in pubs)),
        "seconds_by_part": slam.timings,
    }


def prior_workdir(root: str, device: str, overrides: Sequence[str]) -> str:
    """A working directory for the processes of the reps across ranks:
    links to the repo's ``configs/`` and ``pretrained/``, and the
    workload's prior built here once (the builder's cache, which
    ``load_tsdf_volume`` reads) instead of in every process."""
    from attentive_dfprior_tpu_torch import config
    from attentive_dfprior_tpu_torch.run import apply_overrides
    from attentive_dfprior_tpu_torch.tsdf.builder import save_tsdf_volume

    work = os.path.join(root, "ranks_workdir")
    os.makedirs(work, exist_ok=True)
    for name in ("configs", "pretrained"):
        if not os.path.exists(os.path.join(work, name)):
            os.symlink(os.path.join(REPO, name), os.path.join(work, name))
    cfg = config.load_config(CONFIG, config.default_config_path())
    apply_overrides(cfg, list(overrides))
    save_tsdf_volume(cfg, space=int(cfg.get("tsdf", {}).get("space", 10)), device=device,
                     out_dir=os.path.join(work, f"{cfg['data']['dataset']}_tsdf_volume"))
    return work


def run_ranks(sync: str, frames: int, out: str, device: str, parallel: Dict[str, Any], world: int,
              overrides: Sequence[str], cwd: str) -> Dict[str, Any]:
    """One rep as ``world`` processes joined over gloo (on ``cuda:0`` when
    ``device`` is the card) in the working directory ``cwd``, one torch CPU
    thread each (the ranks share the host's cores); the writer's record,
    with every rank's step modes (``step_mode_by_rank``, in rank order: a
    dp rank's agents run eager on gloo, a split agent alone in its group
    graphed)."""
    from attentive_dfprior_tpu_torch.tools import multihost_smoke as mh

    dev = "cuda:0" if device == "cuda" else device
    spec = {"sync": sync, "frames": frames, "output": out, "device": dev, "backend": "gloo",
            "parallel": parallel, "overrides": list(overrides), "threads": 1}
    results = mh.finish(mh.start("bench", spec, world, cwd=cwd), timeout=3600)
    rec = next(r for r in results if r["writer"])
    rec["step_mode_by_rank"] = [r["step_mode"] for r in sorted(results, key=lambda r: r["rank"])]
    return rec


def main(argv: Optional[List[str]] = None, overrides: Sequence[str] = ()) -> Dict[str, Any]:
    """The harness on ``argv``; ``overrides`` (``--set`` syntax of
    ``run.py``) apply to every rep's config, in this process and in the
    ranks' processes."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--split", default=None, help="'m,t': add the dp reps on m + t ranks and the split reps")
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    ap.add_argument("--out-root", default=None, help="the runs' output directories (default: a temporary one)")
    args = ap.parse_args(argv)

    root = args.out_root or tempfile.mkdtemp(prefix="bench_async_")
    runs: Dict[str, Any] = {}
    for tag, sync in REPS:
        runs[tag] = run_mode(sync, args.frames, os.path.join(root, tag), args.device, overrides=overrides)
        print(json.dumps({tag: runs[tag]}), flush=True)
    if args.split:
        m, t = (int(x) for x in args.split.split(","))
        topologies = {"dp": {"enable": True, "n_devices": m + t},
                      "split": {"enable": True, "split": {"map": m, "track": t}}}
        work = prior_workdir(root, args.device, overrides)
        for tag, sync, topo in RANK_REPS:
            runs[tag] = run_ranks(sync, args.frames, os.path.join(root, tag), args.device, topologies[topo], m + t,
                                  overrides, work)
            print(json.dumps({tag: runs[tag]}), flush=True)
    strict, loose = runs["strict"], runs["loose"]
    summary = {
        "device": args.device,
        "card": card_name_and_power() if args.device == "cuda" else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "wall_strict_over_loose": strict["wall_s"] / loose["wall_s"],
    }
    if args.split:
        summary["speedup_split_vs_strict_dp"] = runs["strict_dp"]["wall_s"] / runs["loose_split"]["wall_s"]
        summary["speedup_split_vs_loose_dp"] = runs["loose_dp"]["wall_s"] / runs["loose_split"]["wall_s"]
        summary["split_note"] = (
            f"every rank of the dp and split reps ({m + t} processes, gloo) runs on "
            + ("cuda:0 of one card and time-slices it, so no rep runs faster than the in-process ones; the ratios "
               "read what dp pays (every rank launches the whole step, plus a gloo sum of the bucket a step) "
               "against split (each rank one agent's work, plus a broadcast a publish), not a speed-up across cards"
               if args.device == "cuda" else
               "the CPU: the ranks share the host's cores, so the ratios read the schedule's cost, not a speed-up")
        )
    payload = {"runs": runs, "summary": summary, "when": time.strftime("%Y-%m-%d %H:%M:%S")}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
    print(json.dumps({"async_bench": summary, "out": args.out}))
    return payload


if __name__ == "__main__":
    main()
