#!/usr/bin/env python3
"""Readings that the limits of ``benchmark/limits/room_tracking.refine.json``
are set from, on the card, in one process for many seeds
(``benchmark/calibrate.py``'s loop, for the refine entry):

    python3 benchmark/calibrate_refine.py --seeds 101,102,103 [--workload room_tracking.refine] [--out F.jsonl]

For each seed: set-up as a run makes it, the program's outputs for the
check collected and its state freed, then the numbers of these sides
against the reference: ``program`` (the lower readings), ``control`` (the
reference in TF32 in the program's place), and each fault of
``benchmark/entries/refine.py:FAULTS`` (a reference with the fault, in the
program's place). A pose left unchanged reads 1 on ``refine_pose`` and
``refine_clamp`` by their definition and is not run. The benchmark's own
runs never run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(workload: str, seed: int, root: str = ROOT, device: str = "cuda:0"):
    from benchmark.entries import refine
    from benchmark.harness import load_cell

    _, cell = load_cell(root, workload, seed, device)
    run = refine.Run(cell)
    run.setup()
    run.collect()
    run.release()
    out = {"workload": workload, "seed": seed, "program": refine.numbers(run),
           "control": refine.numbers(run, tf32=True)}
    for fault in refine.FAULTS:
        out[fault] = refine.numbers(run, fault=fault)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="room_tracking.refine")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[0] = ROOT  # the benchmark as a package from the checkout's root
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = readings(args.workload, seed)
        rec["s"] = time.perf_counter() - t0
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
