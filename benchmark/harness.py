"""The benchmark's driver: finds a cell's configuration, traffic mix, limits
and metrics by name, runs it, and builds the result line.

Everything that belongs to one configuration, mix or metric is a file of
its own, found by the name ``BENCHMARK.json`` gives it:

  - ``benchmark/configs/<config>.json``: the configuration as it is run
    (the ``file`` its entry in ``BENCHMARK.json`` names, which has to be
    this one);
  - ``benchmark/mixes/<traffic>.json``: the traffic's parameters; its
    ``entry`` names the driver in ``benchmark/entries/<entry>.py`` that
    runs this kind of traffic through the program;
  - ``benchmark/limits/<workload>.json``: the limit of each number the
    cell's comparison with the plain reference reads;
  - ``benchmark/metrics/<metric>.py``: a ``read(record)`` that returns the
    metric's value from the run's record, or None where it finds nothing.

A driver (``entries/*.py``) has a ``Run(cell)`` with ``setup()``,
``window(seconds)``, ``trace()``, ``collect()``, ``release()`` and
``check()``: set-up builds the program's objects from the generated inputs
and warms up every shape the window uses, noting its phases in ``marks``;
the window runs the traffic for at least ``seconds`` and closes at the end
of the unit in flight; ``trace`` runs one more unit under the profiler;
``collect`` has the program produce whatever else the check compares;
``release`` frees the program's state; ``check`` runs the reference and
returns the numbers the limits hold.
"""

from __future__ import annotations

import dataclasses
import glob
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "attentive_dfprior_tpu")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def find(root: str, kind: str, name: str) -> str:
    """The one file ``benchmark/<kind>/<name>.*``."""
    hits = [p for p in glob.glob(os.path.join(root, "benchmark", kind, glob.escape(name) + ".*"))
            if os.path.splitext(os.path.basename(p))[0] == name]
    if len(hits) != 1:
        raise FileNotFoundError(f"benchmark/{kind}/{name}.*: {len(hits)} files")
    return hits[0]


def load_metric(root: str, name: str):
    """The reader of metric ``name`` (``benchmark/metrics/<name>.py``)."""
    path = find(root, "metrics", name)
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{abs(hash(path))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict[str, Any]
    cfg: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    device: Any


def load_cell(root: str, workload: str, seed: int, device) -> Tuple[Dict[str, Any], Cell]:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    path = find(root, "configs", entry["name"])
    if os.path.normpath(os.path.join(root, entry["file"])) != os.path.normpath(path):
        raise ValueError(f"configuration {entry['name']!r}: its file is {entry['file']}, not {path}")
    cfg = load_json(path)
    mix = load_json(find(root, "mixes", w["traffic"]))
    limits = load_json(find(root, "limits", workload))
    return bench, Cell(workload, w, cfg, mix, limits, int(seed), device)


def metrics_of(bench: Dict[str, Any], workload: str, traced: bool) -> List[Dict[str, Any]]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer ones:
    a metric with ``workloads`` in those cells, an end-to-end one without
    it in every cell, a per-layer one without it in every cell that
    reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the whole name before the first dot, so the port's own name, which
    starts with the JAX package's, is not one)."""
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def device_info(device, peak: int) -> Dict[str, Any]:
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda", root: str = ROOT,
             t_start: Optional[float] = None) -> Tuple[Dict[str, Any], List[str]]:
    """One run of a cell: set-up, the window, with ``trace`` one traced unit,
    then the comparison with the reference. Returns the result object and
    the lines for standard error, the compared numbers last."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell = load_cell(root, workload, seed, device)
    driver = importlib.import_module(f"benchmark.entries.{cell.mix['entry']}")
    run = driver.Run(cell)
    run.setup()
    setup_s = time.perf_counter() - t_start
    marks = [("process start", t_start)] + run.marks
    record: Dict[str, Any] = {"cfg": cell.cfg, "mix": cell.mix, "cell": cell.workload, "setup_s": setup_s}
    record["window"] = run.window(seconds)
    if trace:
        record["trace"] = run.trace()
    run.collect()
    dev = torch.device(device)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    attempted, failed = run.attempted, run.failed
    run.release()
    numbers = run.check()
    compared = {k: {"value": float(numbers[k]), "limit": float(cell.limits[k])} for k in sorted(cell.limits)}
    correct = failed == 0 and all(v["value"] <= v["limit"] for v in compared.values())
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = load_metric(root, m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    info = device_info(device, peak)
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
                           "metrics": metrics, "device": info}
    if trace:
        t = record["trace"]
        info["busy_s"], info["window_s"] = t["busy_s"], t["window_s"]
        out["breakdown"] = t["breakdown"]
    # the contract's last key: each number compared, beside its limit
    out["compared"] = compared
    lines = ["set-up phases (s): " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:]))
             + f"; set-up {setup_s:.3f}"]
    # the spread inside the window of each call the driver timed one by one
    for key, times in sorted(record["window"].items()):
        if key.endswith("_s") and isinstance(times, list) and times:
            q = np.percentile(1e3 * np.asarray(times), [5, 50, 95])
            lines.append(f"window {key[:-2]} ms: n {len(times)}, p5 {q[0]:.3f}, median {q[1]:.3f}, p95 {q[2]:.3f}")
    if trace:
        own = ", ".join(f"{k} x{n}" for k, n in sorted(record["trace"]["own_kernels"].items()))
        lines.append(f"hand-written kernels in the traced unit: {own or 'none'}")
    lines += [f"compared {k} {v['value']!r} limit {v['limit']!r}" for k, v in compared.items()]
    return out, lines
