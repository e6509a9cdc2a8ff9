"""``k7_roofline``'s arithmetic: K7's least bytes at a render chunk, its
shape from the trace name, and silence on a trace without the kernel."""

import json
import os

import pytest

from benchmark.metrics import k7_roofline
from benchmark.metrics._kernels import HBM_BYTES_PER_S
from benchmark.testing import ROOT


def _record(device):
    with open(os.path.join(ROOT, "benchmark", "configs", "replica-room0.json")) as f:
        cfg = json.load(f)
    return {"cfg": cfg, "trace": {"device": device, "chunk_rays": 10_000, "chunks": 2}}


def test_bytes_at_a_render_chunk():
    # 480,000 points, C = 32: 5.76 MB of points, 61.44 MB a grid written
    assert k7_roofline.k7_bytes(480_000, 32, 1) == 67_200_000
    assert k7_roofline.k7_bytes(480_000, 32, 2) == 128_640_000


def test_shape_from_trace_name():
    assert k7_roofline.k7_shape("void (anonymous namespace)::trilinear_gather_kernel<32, 2>((anonymous "
                                "namespace)::Args)") == (32, 2)
    assert k7_roofline.k7_shape("trilinear_gather_kernel") is None


def test_read_sums_launches():
    single = "void (anonymous namespace)::trilinear_gather_kernel<32, 1>((anonymous namespace)::Args)"
    pair = "void (anonymous namespace)::trilinear_gather_kernel<32, 2>((anonymous namespace)::Args)"
    other = "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, long, long, long, bool)"
    ns = 100_000  # 0.1 ms a launch
    got = k7_roofline.read(_record([(single, 0, ns), (pair, 0, ns), (other, 0, 10 * ns)]))
    want = 100.0 * (67_200_000 + 128_640_000) / HBM_BYTES_PER_S / 2e-4
    assert got == pytest.approx(want)
    assert 0 < got < 100


def test_silent_without_the_kernel():
    other = "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, long, long, long, bool)"
    assert k7_roofline.read(_record([(other, 0, 1000)])) is None
    assert k7_roofline.read({"cfg": {}}) is None
