#!/usr/bin/env python3
"""Run one cell of the benchmark of attentive_dfprior_tpu_torch on the card.

    python3 benchmark/run.py --workload room0.strict --seed 7 --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``), with ``--trace 1`` a ``breakdown``, and last
``compared``: each number the comparison with the plain reference read,
beside its limit. The same numbers are the last lines of standard error.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, when the program cannot be imported, and when a module
of JAX or of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process, few threads: the host's numeric libraries run single-threaded
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# import the benchmark as a package from the checkout's root, never its
# modules by their bare names (benchmark/trace.py is not the standard trace)
sys.path[0] = ROOT
CACHE = os.path.join(ROOT, ".bench_cache")


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        chips = {w["name"]: int(w["chips"]) for w in json.load(f)["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[args.workload]:
        print(f"needs {chips[args.workload]} CUDA device(s); available: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    from benchmark.harness import forbidden_modules, run_cell

    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", ROOT, T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in the process that measured: {', '.join(found)} (JAX or the JAX package)", file=sys.stderr)
        return 3
    print(f"card: {card()}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"process start to torch imported {t_torch - T_START:.3f} s", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
