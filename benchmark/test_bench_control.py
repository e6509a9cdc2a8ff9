"""On the card, at each cell's own size: the program passes every limit of
the cell, and the control (the plain reference in TF32, the precision
below the configuration's float32, put in the program's place) fails at
least one. Skips without a CUDA card: TF32 exists only there.

    python3 -m pytest benchmark/test_bench_control.py -q   (on the card, about 2 min)
"""

import json
import os

import pytest

from benchmark.testing import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    WORKLOADS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limits(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 runs only there")
    from benchmark.calibrate import readings

    with open(os.path.join(ROOT, "benchmark", "limits", f"{workload}.json")) as f:
        limits = json.load(f)
    r = readings(workload, 4242, 3.0, ROOT, "cuda:0")
    assert all(r["program"][k] <= v for k, v in limits.items()), r["program"]
    assert any(r["control"][k] > v for k, v in limits.items()), r["control"]
