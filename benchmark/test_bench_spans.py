"""The readers of the program's spans (``metrics/_spans.py`` and the two
metrics on it) on synthetic spans and device events: sums per call, the
device's idle time inside the mapper's host work (an idle
stretch a span half covers among them), the traced unit's spans told from
an earlier run's, and None where the program records no spans."""

import math

import pytest

from benchmark.harness import ROOT, load_json, load_metric, metrics_of
from benchmark.metrics import _spans

MS = 1_000_000  # ns
T0 = 10**18  # spans and device events on the kineto clock: Unix-epoch ns
READERS = ("mask_ms_per_map", "idle_in_mapper_host_pct")


class FakeSpan:
    def __init__(self, name, a_ms, b_ms, **attrs):
        self.name, self.start_ns, self.end_ns, self.attrs = name, T0 + int(a_ms * MS), T0 + int(b_ms * MS), attrs


def cycle(offset_ms=0.0):
    """A strict cycle's spans: two tracked frames, three replays, one map
    whose masks take 150 ms and whose window copies 20 ms."""
    o = offset_ms
    out = []
    for f, a in ((1, 0.0), (2, 40.0)):
        out += [FakeSpan("Tracker.track", o + a, o + a + 30, frame=f), FakeSpan("Tracker.inputs", o + a, o + a + 1),
                FakeSpan("Tracker.pose_to_host", o + a + 20, o + a + 30)]
    out += [FakeSpan("Mapper.optimize_map", o + 50, o + 1000, frame=5),
            FakeSpan("Mapper.frustum_masks", o + 50, o + 200), FakeSpan("Mapper.window", o + 300, o + 320),
            FakeSpan("StepGraph.replay", o + 330, o + 330.3), FakeSpan("StepGraph.replay", o + 331, o + 331.5),
            FakeSpan("StepGraph.replay", o + 332, o + 333)]
    return out


def device(*ranges_ms):
    return [("kernel", T0 + int(a * MS), int((b - a) * MS)) for a, b in ranges_ms]


# the device busy in [0, 100) and [300, 1000) ms of a 1 s window: the idle
# stretch [100, 300) is half covered by the masks' span [50, 200)
TRACE = {"device": device((0, 100), (300, 1000)), "window_s": 1.0}


@pytest.fixture
def recorder(monkeypatch):
    from attentive_dfprior_tpu_torch.utils import profiling

    held = []
    monkeypatch.setattr(profiling, "spans", lambda: sorted(held, key=lambda s: s.start_ns))
    return held


def read(name, record):
    return load_metric(ROOT, name).read(record)


def test_readers_on_one_cycle(recorder):
    recorder += cycle()
    record = {"trace": TRACE}
    assert math.isclose(read("mask_ms_per_map", record), 150.0)
    # the masks' [100, 200) ms of the idle stretch; the window's copies run while the device is busy
    assert math.isclose(read("idle_in_mapper_host_pct", record), 10.0)


def test_idle_counts_only_the_uncovered_part_of_each_span(recorder):
    recorder += cycle()
    # the window's span [300, 320) now straddles the device's resumption at 310
    record = {"trace": {"device": device((0, 100), (310, 1000)), "window_s": 2.0}}
    assert math.isclose(read("idle_in_mapper_host_pct", record), 100.0 * (100 + 10) / 2000)
    # [0, 20) less [2, 4) and [8, 20); [30, 40) less [30, 32) and [39, 40)
    assert _spans.uncovered_ns([(0, 10), (5, 20), (30, 40)], [(2, 4), (8, 32), (39, 50)]) == 6 + 7
    assert _spans.uncovered_ns([(0, 10)], []) == 10 and _spans.uncovered_ns([], [(0, 1)]) == 0


def test_an_earlier_runs_spans_are_left_out(recorder):
    recorder += cycle(offset_ms=-5000) + cycle()  # an earlier traced run in the same process
    record = {"trace": TRACE}
    assert math.isclose(read("mask_ms_per_map", record), 150.0)
    assert math.isclose(read("idle_in_mapper_host_pct", record), 10.0)
    spans = _spans.traced_spans(record)
    assert _spans.count(spans, "Mapper.optimize_map") == 1 and len(spans) == len(cycle())


def test_two_maps_average(recorder):
    recorder += cycle() + [FakeSpan("Mapper.optimize_map", 1100, 1500), FakeSpan("Mapper.frustum_masks", 1100, 1270)]
    record = {"trace": {"device": device((0, 2000)), "window_s": 2.0}}
    assert math.isclose(read("mask_ms_per_map", record), 160.0)


@pytest.mark.parametrize("name", READERS)
def test_none_without_spans(recorder, monkeypatch, name):
    from attentive_dfprior_tpu_torch.utils import profiling

    assert read(name, {"trace": TRACE}) is None  # the recorder holds nothing
    recorder += cycle()
    assert read(name, {}) is None  # an untraced run
    assert read(name, {"trace": {"device": device((5000, 6000)), "window_s": 1.0}}) is None  # none in the trace
    monkeypatch.delattr(profiling, "spans")  # a program without spans, as before it had them
    assert read(name, {"trace": TRACE}) is None


def test_given_poses_leave_the_mapper_metrics(recorder):
    recorder += [s for s in cycle() if s.name not in ("Tracker.inputs", "Tracker.pose_to_host", "StepGraph.replay")]
    assert read("mask_ms_per_map", {"trace": TRACE}) == 150.0
    assert math.isclose(read("idle_in_mapper_host_pct", {"trace": TRACE}), 10.0)


def test_the_readers_are_the_cells_metrics():
    bench = load_json(f"{ROOT}/BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert entries[name]["source"] == "program_span"
    strict = {m["name"] for m in metrics_of(bench, "room0.strict", True)}
    assert set(READERS) <= strict
    assert set(READERS) <= {m["name"] for m in metrics_of(bench, "scene0000.strict", True)}
    assert not set(READERS) & {m["name"] for m in metrics_of(bench, "room0.render", True)}
