#!/usr/bin/env python3
"""Readings that the limits of ``benchmark/limits/<workload>.json`` are set
from, on the card, in one process for many seeds:

    python3 benchmark/calibrate.py --workload room0.strict --seeds 101,102,103 [--seconds 3] [--out F.jsonl]

For each seed: set-up as a run makes it (for render traffic also a short
window, which renders the frames the check samples), the program's outputs
for the check collected and its state freed, then the numbers of three sides against the reference: ``program``
(the lower readings), ``control`` (the reference in TF32 in the program's
place) and, for strict traffic, ``half`` (the reference on half of each
batch, the loss scaled to the whole: a fault). A state left unchanged
reads 1 on ``map_change``, ``track_change`` and ``track_pose`` by their
definition and is not run. The benchmark's own runs never run this.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload: str, seed: int, seconds: float, root: str = ROOT, device: str = "cuda:0"):
    from benchmark.harness import load_cell
    from benchmark.reference import compare

    _, cell = load_cell(root, workload, seed, device)
    run = importlib.import_module(f"benchmark.entries.{cell.mix['entry']}").Run(cell)
    run.setup()
    if cell.mix["entry"] == "render":
        run.window(seconds)
    run.collect()
    run.release()
    out = {"workload": workload, "seed": seed}
    if cell.mix["entry"] == "strict":
        out["program"] = compare.strict_numbers(run)
        out["control"] = compare.strict_numbers(run, tf32=True)
        out["half"] = compare.strict_numbers(run, half=True)
    else:
        frames = compare.render_sample(run)
        ref = compare.reference_render(run, frames)
        control = compare.reference_render(run, frames, tf32=True)
        program = {i: run.outputs[i][1:] for i in frames}
        out["program"] = compare.render_gaps(program, ref)
        out["control"] = compare.render_gaps(control, ref)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[0] = ROOT  # the benchmark as a package from the checkout's root
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = readings(args.workload, seed, args.seconds)
        rec["s"] = time.perf_counter() - t0
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
