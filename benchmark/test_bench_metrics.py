"""The metric arithmetic, pinned to the counts the port's kernel table
states (PERF.md, kernel table), and the busy share's union of intervals."""

import json
import math
import os

import pytest

from benchmark.metrics import _intervals, _kernels, _work
from benchmark.testing import ROOT


def _cfg(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_k1_bound_room0_high_grid():
    # 74 x 56 x 44 cells, C = 32: 0.0627 ms at 3.35 TB/s
    ms = 1e3 * _kernels.k1_bytes(74 * 56 * 44, 32) / _kernels.HBM_BYTES_PER_S
    assert round(ms, 4) == 0.0627


def test_k4_bound_room0_colour_rows():
    # 48,000 ray-shaped rows x 256 into 182,336 cells: 0.0705 ms
    ms = 1e3 * _kernels.k4_bytes(48_000, 256, 182_336) / _kernels.HBM_BYTES_PER_S
    assert round(ms, 4) == 0.0705


def test_k2_flops_at_480k_points():
    # the low decoder (c 32, one output): 30,958 FLOPs a point; three
    # passes of them at the TF32 peak are the 0.0901 ms of the kernel table
    assert _kernels.decoder_flops(32, 1) == 30_958
    flops = 480_000 * _kernels.decoder_flops(32, 1)
    assert round(1e3 * 3 * flops / _kernels.TF32_FLOPS_PER_S, 4) == 0.0901
    # the bound is the work's own: one pass, larger than its bytes' time
    assert _kernels.k2_bound_s(480_000, 32, 1) == pytest.approx(flops / _kernels.TF32_FLOPS_PER_S)


def test_k2_shape_from_trace_name():
    assert _kernels.k2_shape("void decoder_mlp_kernel<64, 1>(float const*, float const*)") == (64, 1)
    assert _kernels.function_name("void pass_kernel<true>(long long const*, int)") == "pass_kernel"
    assert _kernels.function_name("halo_fold_kernel(float const*, float*)") == "halo_fold_kernel"
    assert not _kernels.is_kernel("void at::native::reduce_kernel<512, 1>(...)", _kernels.K4_NAMES)


@pytest.mark.parametrize("name,k1", [("replica-room0", 95), ("scannet-scene0000", 95)])
def test_grid_gradient_calls(name, k1):
    cfg = _cfg(name)
    assert _work.stage_iters(cfg) == {"low": 25, "high": 12, "color": 23}
    calls = _work.grid_gradient_calls(cfg)
    assert len(calls) == k1  # one K4 and one K1 a grid gradient, 95 a cycle
    rows = 1000 * 48 if name == "replica-room0" else 5000 * 48
    assert {c[0] for c in calls} == {rows}


def test_model_flops_room0_cycle():
    cfg = _cfg("replica-room0")
    f = _work.cycle_flops(cfg)
    # mapping: 48,000 points x (25 low, 12 high, 23 colour iterations);
    # tracking: 5 frames x 10 iterations x 9,600 points x (forward + backward)
    assert f["map"] == 48_000 * (25 * 61_916 + 12 * 342_456 + 23 * 435_906)
    assert f["track"] == 5 * 10 * 200 * 48 * 2 * 169_354
    # never more than the work the program does: 3 x the forward of all four
    everything = 3 * 169_354 * (60 * 48_000 + 5 * 10 * 200 * 48)
    assert sum(f.values()) < everything


def test_render_flops():
    cfg = _cfg("replica-room0")
    assert _work.render_flops(cfg, 680, 1200) == 680 * 1200 * 48 * 169_354


@pytest.mark.parametrize("intervals,window,busy", [
    ([(0, 10), (5, 15), (20, 30)], 40, 25),
    ([(0, 100), (10, 20), (30, 40), (50, 60)], 100, 100),  # nested: never over 100 %
    ([(0, 10), (0, 10), (0, 10)], 10, 10),  # three streams at once
    ([], 10, 0),
])
def test_union_never_over_window(intervals, window, busy):
    assert _intervals.union_ns(intervals) == busy
    assert 0.0 <= _intervals.idle_pct(intervals, window) <= 100.0
    assert math.isclose(_intervals.idle_pct(intervals, window), 100.0 * (1 - busy / window))


def test_idle_gaps():
    assert _intervals.idle_gaps([(0, 10), (5, 15), (20, 30), (31, 40)]) == [(15, 20), (30, 31)]
