"""A copy of the benchmark at a tiny size, for the CPU tests: the same
harness, drivers, metrics and limits, with room0's configuration cut to a
2.5 x 2.2 x 1.8 m bound, a 24 x 32 camera, an 0.125 m prior and a few rays
and iterations, in a directory of its own."""

from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SEED = 2**31 + 17  # a seed past 32 signed bits, as a benchmark run's may be


def tiny_cfg() -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", "replica-room0.json")) as f:
        cfg = json.load(f)
    cfg["mapping"].update(bound=[[-1.0, 1.5], [-1.0, 1.2], [-0.8, 1.0]], pixels=40, iters=6)
    cfg["cam"].update(H=24, W=32, fx=20.0, fy=20.0, cx=15.5, cy=11.5)
    cfg["tsdf"]["voxel_size"] = 0.125
    cfg["tracking"].update(pixels=30, iters=3, ignore_edge_W=2, ignore_edge_H=2)
    return cfg


def tiny_root(tmp: str) -> str:
    """``tmp`` made a checkout root holding BENCHMARK.json and the benchmark
    with the room0 cells on the tiny configuration (render chunks of 200
    rays). Returns ``tmp``."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(tmp, "benchmark"), dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(tmp, "benchmark", "configs", "tiny.json"), "w") as f:
        json.dump(tiny_cfg(), f)
    mix_path = os.path.join(tmp, "benchmark", "mixes", "render.json")
    with open(mix_path) as f:
        mix = json.load(f)
    mix["ray_batch_size"] = 200
    with open(mix_path, "w") as f:
        json.dump(mix, f)
    bench["configs"].append(dict(bench["configs"][0], name="tiny", file="benchmark/configs/tiny.json"))
    for w in bench["workloads"]:
        if w["config"] == "replica-room0":
            w["config"] = "tiny"
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp
