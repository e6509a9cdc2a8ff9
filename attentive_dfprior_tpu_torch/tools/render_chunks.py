"""The render's ray chunk size against its seconds and its graph pool.

    python -m attentive_dfprior_tpu_torch.tools.render_chunks [CONFIG]
        [--chunks 2500,5000,10000] [--reps 4] [--end_idx 1] [--device cuda|cpu]
        [--set key=value ...] [--out PATH]

Runs the config's first ``--end_idx`` frames as ``run.py`` does (default
``configs/Synthetic/room_tracking.yaml``, 240x320), then renders the last
of them, with its sensor depth, from the run's scene at each chunk size of
``--chunks``. Each chunk size gets a ``Renderer`` with a fresh
``ForwardGraphs`` (``utils/step_graph.py``) per mode, so that a graphed
renderer's pool holds that chunk size's program alone: one render first
(the warm-ups and the capture), then ``--reps`` renders per mode, graphed
and eager in turns (graph, eager, eager, graph, ...), each timed on the
host's clock between two ``torch.cuda.synchronize()``. For each chunk size
it prints the median seconds of each mode and the GiB that the graphed
renderer's pool holds (``ForwardGraphs.stats()``'s ``pool_gib``), and the
largest depth gap to the render at the first chunk size (the chunk's max
depth sets its far plane, so the chunk size may move a ray's samples).
The last line is one JSON object; ``--out`` writes it to a file as well.
On the CPU only eager runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from attentive_dfprior_tpu_torch import run as run_mod
from attentive_dfprior_tpu_torch.render.renderer import Renderer
from attentive_dfprior_tpu_torch.utils.step_graph import ForwardGraphs

DEFAULT_CONFIG = "configs/Synthetic/room_tracking.yaml"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or "not measured"."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not measured"


def measure(slam, idx: int, chunks: List[int], reps: int) -> List[Dict[str, Any]]:
    """Seconds per render of frame ``idx`` and pool GiB at each chunk size
    (module docstring)."""
    dev = slam.device
    _, _, depth, _ = slam.dataset[idx]
    c2w = slam.estimate_c2w_list[idx]
    modes = ["graph", "eager"] if dev.type == "cuda" else ["eager"]
    rows, first = [], None
    for chunk in chunks:
        renderers = {m: Renderer(slam.rcfg, slam.scene_cfg.bound, slam.tsdf_bnds, slam.cam, dev, ray_batch_size=chunk,
                                 graphs=ForwardGraphs(m, dev)) for m in modes}

        def render(mode):
            out = renderers[mode].render_img(slam.params, c2w, slam.tsdf_volume, gt_depth=depth)
            _sync(dev)
            return out

        outs = {m: render(m) for m in modes}
        times: Dict[str, List[float]] = {m: [] for m in modes}
        order = (["graph", "eager", "eager", "graph"] if len(modes) == 2 else ["eager"]) * reps
        for mode in order[: reps * len(modes)]:
            t0 = time.perf_counter()
            render(mode)
            times[mode].append(time.perf_counter() - t0)
        d = outs[modes[0]][0]
        first = d if first is None else first
        row = {"chunk": chunk, "chunks_a_render": -(-slam.cam.H * slam.cam.W // chunk),
               "depth_max_abs_vs_first_chunk_m": float((d - first).abs().max())}
        for mode in modes:
            row[f"{mode}_s"] = float(np.median(times[mode]))
            row[f"{mode}_s_all"] = times[mode]
        if "graph" in modes:
            row["graph_equal_eager"] = all(torch.equal(a, b) for a, b in zip(outs["graph"], outs["eager"]))
            row["pool_gib"] = renderers["graph"].graphs.stats()["pool_gib"]
        print(json.dumps(row), flush=True)
        rows.append(row)
        del renderers, outs
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description="Render seconds and graph pool by ray chunk size.")
    parser.add_argument("config", nargs="?", default=DEFAULT_CONFIG)
    parser.add_argument("--chunks", default="2500,5000,10000")
    parser.add_argument("--reps", type=int, default=4)
    parser.add_argument("--end_idx", type=int, default=1)
    parser.add_argument("--device", default=None)
    parser.add_argument("--set", dest="overrides", action="append", default=[])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    chunks = [int(c) for c in args.chunks.split(",")]
    with tempfile.TemporaryDirectory(prefix="render_chunks_") as out_dir:
        run_argv = [args.config, "--output", out_dir, "--end_idx", str(args.end_idx)]
        if args.device:
            run_argv += ["--device", args.device]
        for item in args.overrides:
            run_argv += ["--set", item]
        slam = run_mod.main(run_argv)
        rows = measure(slam, args.end_idx - 1, chunks, args.reps)
    payload = {"card": card_line() if slam.device.type == "cuda" else "cpu", "config": args.config,
               "frame": args.end_idx - 1, "image": [slam.cam.H, slam.cam.W], "reps": args.reps, "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps(payload) + "\n")
    print(json.dumps(payload), flush=True)
    return payload


if __name__ == "__main__":
    main()
