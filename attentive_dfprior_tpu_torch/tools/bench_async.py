"""Strict against loose on one device: the port of ``scripts/bench_async.py``.

    python -m attentive_dfprior_tpu_torch.tools.bench_async [--frames 20]
        [--device cuda|cpu] [--out PATH] [--out-root DIR]

Runs the same short ``configs/Synthetic/room_tracking.yaml`` workload
(``data.n_frames`` set to ``--frames``, seed 0, checkpoints and meshes off)
three times in one process, as the JAX harness's ``strict_warm``, ``loose``
and ``strict`` reps: the first strict rep pays the one-off costs (kernel
builds, the frames rendered on the host), so compare the second strict rep
with the loose one. For each rep it reads the per-event wall-clock stamps in
``metrics.jsonl``: wall seconds of ``run()``, frames tracked and mapped, the
median and 90th percentile of the interval between tracked frames, and the
loose rep's publishes, skipped publishes and seconds spent publishing.

On the card the loose rep's mapper runs on its own thread and CUDA stream
(``slam/system.py:_run_async``), so its kernels may overlap the tracker's;
whether that shortens the run is what the record says. Runs on the card
unless ``--device cpu`` is given. The JAX harness's split-device and
data-parallel reps need the sharding slice and are not here.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "Synthetic", "room_tracking.yaml")
REPS = (("strict_warm", "strict"), ("loose", "loose"), ("strict", "strict"))


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of the card, or a note why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "not read"


def run_mode(sync: str, frames: int, out: str, device: str) -> Dict[str, Any]:
    """One rep: a fresh SLAMSystem on the workload under ``sync``; its record."""
    from attentive_dfprior_tpu_torch import config
    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem

    cfg = config.load_config(CONFIG, config.default_config_path())
    cfg["seed"] = 0
    cfg["sync_method"] = sync
    cfg["data"]["n_frames"] = frames
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

    events = [json.loads(ln) for ln in open(os.path.join(out, "metrics.jsonl"))]
    tracks = [e for e in events if e["event"] == "track"]
    pubs = [e for e in events if e["event"] == "publish"]
    iv = np.diff([e["t"] for e in tracks]) if len(tracks) > 1 else np.zeros(0)
    return {
        "sync_method": sync,
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


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    ap.add_argument("--out-root", default=None, help="the runs' output directories (default: a temporary one)")
    args = ap.parse_args(argv)

    root = args.out_root or tempfile.mkdtemp(prefix="bench_async_")
    runs: Dict[str, Any] = {}
    for tag, sync in REPS:
        runs[tag] = run_mode(sync, args.frames, os.path.join(root, tag), args.device)
        print(json.dumps({tag: runs[tag]}), flush=True)
    strict, loose = runs["strict"], runs["loose"]
    summary = {
        "device": args.device,
        "card": card_name_and_power() if args.device == "cuda" else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "wall_strict_over_loose": strict["wall_s"] / loose["wall_s"],
    }
    payload = {"runs": runs, "summary": summary, "when": time.strftime("%Y-%m-%d %H:%M:%S")}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
    print(json.dumps({"async_bench": summary, "out": args.out}))
    return payload


if __name__ == "__main__":
    main()
