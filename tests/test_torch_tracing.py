"""The port's spans (``attentive_dfprior_tpu_torch/utils/profiling.py``):
the recorder's nesting, threads, gating and cost when off, its clock
against the profiler's kineto events, and the span trees the agents'
entry calls give on the CPU.
"""

from __future__ import annotations

import ast
import collections
import json
import os
import tempfile
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from attentive_dfprior_tpu_torch.utils import profiling
from attentive_dfprior_tpu_torch.utils.profiling import (
    PhaseTimer, Span, recording, self_ns, span, spans, take, torch_trace,
)
from test_torch_imports import PKG, REPO


def tree(records, root):
    """(name, [children's trees]) under ``root``, in start order."""
    return (root.name, [tree(records, c) for c in sorted(profiling.children(root, records), key=lambda s: s.start_ns)])


def roots(records, name):
    return [s for s in records if s.parent is None and s.name == name]


@pytest.fixture(autouse=True)
def clean():
    take()
    yield
    take()


def test_nesting_and_parents_on_two_threads():
    barrier = threading.Barrier(2)

    def work(tag):
        with span(f"{tag}.outer", frame=1):
            barrier.wait()  # both threads inside their outer span at once
            with span(f"{tag}.inner"):
                barrier.wait()
            with span(f"{tag}.inner", iteration=2):
                pass

    with recording():
        threads = [threading.Thread(target=work, args=(t,)) for t in ("A", "B")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    records = spans()
    assert len(records) == 6 and records == sorted(records, key=lambda s: s.start_ns)
    assert spans() == records  # spans() keeps them
    for tag in ("A", "B"):
        (outer,) = roots(records, f"{tag}.outer")
        inner = [s for s in records if s.name == f"{tag}.inner"]
        assert [s.parent for s in inner] == [outer, outer]  # never the other thread's span
        assert all(outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns for s in inner)
        assert {s.tid for s in inner} == {outer.tid} and outer.attrs == {"frame": 1}
        assert [s.attrs for s in inner] == [{}, {"iteration": 2}]
    assert roots(records, "A.outer")[0].tid != roots(records, "B.outer")[0].tid
    assert len(take()) == 6 and spans() == [] and take() == []


def _span(name, a, b, parent=None):
    s = Span(name, {})
    s.start_ns, s.end_ns, s.parent = a, b, parent
    return s


def test_self_ns_is_the_duration_less_the_children():
    root = _span("root", 0, 100)
    kids = [_span("a", 10, 30, root), _span("b", 25, 40, root), _span("c", 90, 130, root)]
    grandchild = _span("g", 12, 20, kids[0])
    other = _span("x", 0, 100)
    records = [root, *kids, grandchild, other]
    # children's union [10, 40) and [90, 100) clipped: 40 ns; the grandchild counts for its parent only
    assert self_ns(root, records) == 60
    assert self_ns(kids[0], records) == 12 and self_ns(grandchild, records) == 8
    assert self_ns(other, records) == 100


def test_off_records_nothing_allocates_nothing_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while off")

    monkeypatch.setattr(profiling, "_clock", no_clock)
    assert span("A.b") is span("C.d", frame=3)  # one shared object: nothing made per span
    for _ in range(100):  # warm every code path first
        with span("A.b", frame=1) as s:
            assert s is None
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for i in range(10_000):
            with span("A.b", frame=i):
                pass
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 1024, grown  # a byte kept per span would be 10 kB
    assert spans() == []


def test_recording_and_the_profiler_gate_the_recorder():
    with span("Off.first"):
        pass
    with recording():
        with recording():
            with span("On.nested"):
                pass
        with span("On.outer"):
            pass
    with span("Off.after"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with span("On.profiled"):
            pass
    with span("Off.last"):
        pass
    assert [s.name for s in spans()] == ["On.nested", "On.outer", "On.profiled"]


def test_sessions_in_a_row_do_not_pile_up_records(monkeypatch):
    for session in ("A", "B"):  # each outermost recording() starts empty
        with recording():
            with span(f"{session}.first"):
                with recording():  # an inner block keeps what is there
                    with span(f"{session}.second"):
                        pass
        assert [s.name for s in spans()] == [f"{session}.first", f"{session}.second"]
    # under bare profilers the recorder keeps the newest KEEP spans
    assert profiling._records.maxlen == profiling.KEEP
    monkeypatch.setattr(profiling, "_records", collections.deque(maxlen=3))
    for session in ("C", "D"):
        with profile(activities=[ProfilerActivity.CPU]):
            for i in range(2):
                with span(f"{session}.{i}"):
                    pass
    assert [s.name for s in spans()] == ["C.1", "D.0", "D.1"]


def test_torch_trace_writes_each_workers_pair(tmp_path):
    for worker in ("rank0", "rank1"):  # two ranks' traces in one directory
        with torch_trace(str(tmp_path), worker=worker):
            with span(f"{worker}.region"):
                torch.ones(3).sum()
        assert spans() == []  # taken by the exporter
    for worker in ("rank0", "rank1"):
        (trace,) = tmp_path.glob(f"{worker}.*.pt.trace.json")
        (pair,) = tmp_path.glob(f"{worker}.*.spans.json")
        assert pair.name == trace.name.replace(".pt.trace.json", ".spans.json")
        ours, kineto = json.loads(pair.read_text()), json.loads(trace.read_text())
        assert [e["name"] for e in ours["traceEvents"]] == [f"{worker}.region"]
        assert ours["baseTimeNanoseconds"] == kineto.get("baseTimeNanoseconds", 0)


def test_phase_timer_phases_are_spans():
    timer = PhaseTimer()
    with recording():
        with timer.phase("map", rays=10):
            with span("Mapper.optimize_map"):
                pass
    (phase,) = roots(spans(), "map")
    assert tree(spans(), phase) == ("map", [("Mapper.optimize_map", [])])
    assert timer.counts["map"] == 1 and timer.rays["map"] == 10


def test_a_span_and_a_record_function_share_the_clock():
    """A span around a CPU ``record_function`` contains its kineto event,
    to within 100 us at each end (the best of 20: the clock's agreement,
    not the scheduler's)."""
    marks = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):  # the first one pays the profiler's set-up
            pass
        for i in range(20):
            with span(f"Clock.span{i}") as s:
                with record_function(f"clock_rf{i}"):
                    time.sleep(0.001)
            marks[f"clock_rf{i}"] = s
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name() in marks}
    assert len(events) == 20
    gaps = []
    for name, s in marks.items():
        e = events[name]
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        # contained, up to the profiler's microsecond rounding
        assert s.start_ns <= start + 2_000 and end <= s.end_ns + 2_000, (name, s.start_ns - start, s.end_ns - end)
        gaps.append(max(abs(start - s.start_ns), abs(s.end_ns - end)))
    assert min(gaps) < 100_000, gaps


# ------------------------------------------------------------ the agents


@pytest.fixture(scope="module")
def slam():
    from attentive_dfprior_tpu_torch.slam.system import SLAMSystem
    from test_torch_slam import tiny_room_cfg

    cfg = tiny_room_cfg()
    cfg["seed"] = 0
    return SLAMSystem(cfg, output=tempfile.mkdtemp(prefix="tracing_"), device="cpu")


def test_optimize_map_gives_the_span_tree(slam):
    m = slam.mapper
    _, color, depth, gt = slam.dataset[0]
    c, d = slam._to_device(color)[None], slam._to_device(depth)[None]
    with recording():
        _, _, _, stage_losses = m.optimize_map(slam.params, m.num_joint_iters, m.lr_factor, 5, c, d,
                                               np.asarray(gt)[None], generator=slam.generator,
                                               cur_depth_np=np.asarray(depth), cur_c2w_np=gt)
    records = spans()
    (root,) = roots(records, "Mapper.optimize_map")
    assert root.attrs == {"frame": 5} and len(records) == 1 + 2 + len(stage_losses) + m.num_joint_iters + 1
    stages = [(st, [("StepGraph.eager", [])] * len(ls)) for st, ls in stage_losses.items()]
    assert tree(records, root) == ("Mapper.optimize_map", [
        ("Mapper.frustum_masks", []), ("Mapper.window", []),
        *[("Mapper.stage", kids) for _, kids in stages], ("Mapper.losses_to_host", [])])
    stage_spans = [s for s in records if s.name == "Mapper.stage"]
    assert [s.attrs for s in stage_spans] == [{"stage": st, "iterations": len(ls)} for st, ls in stage_losses.items()]
    # the children name all but a sliver of the call's host time
    assert self_ns(root, records) < 0.05 * root.duration_ns


def test_track_gives_the_span_tree(slam):
    t = slam.tracker
    assert not t.gt_camera
    _, color, depth, gt = slam.dataset[2]
    est = np.stack([slam.dataset[i][3] for i in range(3)]).astype(np.float32)
    with recording():
        t.track(slam.params, 2, slam._to_device(color), slam._to_device(depth), gt, est, generator=slam.generator)
    records = spans()
    (root,) = roots(records, "Tracker.track")
    assert root.attrs == {"frame": 2}
    assert tree(records, root) == ("Tracker.track", [
        ("Tracker.inputs", []), *[("StepGraph.eager", [])] * t.num_cam_iters, ("Tracker.pose_to_host", [])])
    take()
    t.gt_camera = True  # the given pose handed back: the root alone
    try:
        with recording():
            t.track(slam.params, 3, slam._to_device(color), slam._to_device(depth), gt, est)
    finally:
        t.gt_camera = False
    assert [(s.name, s.parent) for s in spans()] == [("Tracker.track", None)]


def test_select_window_is_a_span(slam):
    _, color, depth, gt = slam.dataset[0]
    with recording():
        slam._select_window(color, depth, np.asarray(gt))
    assert [s.name for s in spans()] == ["SLAMSystem._select_window"]


def test_render_img_gives_one_chunk_span_a_chunk():
    from attentive_dfprior_tpu_torch.models.scene import params_from_numpy
    from test_torch_render_graph import _renderer, _scene, _stub_graphs

    params, bound, tsdf, c2w, _ = _scene()
    tp, tt = params_from_numpy(params), torch.tensor(tsdf)
    n = 5  # 140 rays in chunks of 30
    for graphs in (None, _stub_graphs()):
        take()
        r = _renderer(bound, 30, graphs=graphs)
        with recording():
            r.render_img(tp, c2w, tt)
        records = spans()
        (root,) = roots(records, "Renderer.render_img")
        chunks = profiling.children(root, records)
        assert [s.name for s in chunks] == ["Renderer.chunk"] * n and len(records) == 1 + n + (0 if graphs is None
                                                                                            else n + 1)
        assert [s.attrs for s in chunks] == [{"chunk": i} for i in range(n)]
        kids = [[c.name for c in profiling.children(s, records)] for s in chunks]
        if graphs is None:  # eager: the chunk's render in Python
            assert kids == [[]] * n
        else:  # a stub graph: two warm-ups, then a capture, and a replay a chunk from there on
            assert kids == [["StepGraph.warmup"], ["StepGraph.warmup"], ["StepGraph.capture", "StepGraph.replay"],
                            ["StepGraph.replay"], ["StepGraph.replay"]]


def test_step_graph_spans_warmup_capture_and_replay(monkeypatch):
    from attentive_dfprior_tpu_torch.ops.cuda import build
    from attentive_dfprior_tpu_torch.utils import step_graph as sg
    from attentive_dfprior_tpu_torch.utils.step_graph import StepGraphs
    from test_torch_step_graph import StubGraph

    monkeypatch.setattr(build, "capturing_stream", lambda: 0 if StubGraph.capturing else None)
    graphs = StepGraphs("graph", "cpu", graph_factory=StubGraph)
    graph = graphs.step_graph(lambda: None)
    with recording():
        for _ in range(5):
            graph()
    names = [s.name for s in spans()]
    assert names == ["StepGraph.warmup"] * sg.WARMUP_ITERS + ["StepGraph.capture"] + \
        ["StepGraph.replay"] * (5 - sg.WARMUP_ITERS)
    assert [s.attrs for s in spans() if s.name == "StepGraph.warmup"] == [{"iteration": i} for i in range(2)]
    assert [s.attrs for s in spans() if s.name == "StepGraph.capture"] == [{"captures": 1}]


def _port_sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("path", sorted(_port_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_no_device_annotation_inside_the_port(path):
    """No ``record_function`` or NVTX range in the port: either puts an
    annotation on the device's timeline, which the benchmark would count
    as device work."""
    tree_ = ast.parse(open(path).read(), filename=path)
    names = {n.attr for n in ast.walk(tree_) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree_) if isinstance(n, ast.Name)}
    names |= {a.name for n in ast.walk(tree_) if isinstance(n, ast.ImportFrom) for a in n.names}
    assert not names & {"record_function", "nvtx", "emit_nvtx", "range_push"}, os.path.relpath(path, REPO)
