"""The device trace of a traced run: ``torch.profiler`` over whole cycles
(or whole frames), its events summed straight from the kineto results.

``device_events`` keeps every operation that ran on the device (kernels,
copies, fills) as (name, start ns, duration ns); ``host_events`` the host's
operators and the harness's own spans, to name what the host was doing
while the device idled. The busy time is the union of the device
intervals, so work on two streams at once is counted once.
"""

from __future__ import annotations

import contextlib
import heapq
import time
from typing import Any, Dict, List, Set, Tuple

from benchmark.metrics._intervals import idle_gaps, union_ns

Event = Tuple[str, int, int]
SPANS: Set[str] = set()  # names of the harness's spans


@contextlib.contextmanager
def traced(sync, out: Dict[str, Any]):
    """Profile the body (CPU and CUDA activity); on exit ``out`` holds
    ``device`` and ``host`` event lists and ``window_s``, the host clock's
    seconds from the synchronised start to the synchronised end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        out["window_s"] = time.perf_counter() - t0
    device: List[Event] = []
    host: List[Event] = []
    for e in prof.profiler.kineto_results.events():
        dur = e.duration_ns()
        if dur <= 0:
            continue
        on_device = e.device_type() == DeviceType.CUDA and e.name() not in SPANS  # a span's device copy is no work
        (device if on_device else host).append((e.name(), e.start_ns(), dur))
    out["device"], out["host"] = device, host


def span(name: str):
    """A span of the harness's own around a call into the program (a
    ``record_function``: it costs a few microseconds with the profiler
    off). The trace also shows it on the device's timeline, where it is
    left out of the device's work."""
    from torch.profiler import record_function

    SPANS.add(name)
    return record_function(name)


def own_kernels(device: List[Event]) -> Dict[str, int]:
    """Launches of the port's hand-written kernels on these paths (K1, K4,
    K2; ``benchmark/metrics/_kernels.py``'s names), by function name."""
    from benchmark.metrics._kernels import K1_NAMES, K2_NAME, K4_NAMES, function_name

    own = set(K1_NAMES) | set(K4_NAMES) | {K2_NAME}
    counts: Dict[str, int] = {}
    for name, _, _ in device:
        f = function_name(name)
        if f in own:
            counts[f] = counts.get(f, 0) + 1
    return counts


def summary(trace: Dict[str, Any], top: int = 10) -> Dict[str, Any]:
    """``busy_s`` (the union of the device's intervals), ``window_s`` and
    the breakdown: the device operations that took most time, and the
    idle stretches summed by the host operation running half-way through
    them (the innermost one: the harness's span around the call into the
    program where no operator of the program runs)."""
    dev = trace["device"]
    busy = union_ns([(s, s + d) for _, s, d in dev]) / 1e9
    by_op: Dict[str, float] = {}
    for name, _, d in dev:
        by_op[name] = by_op.get(name, 0.0) + d / 1e9
    gaps = idle_gaps([(s, s + d) for _, s, d in dev])
    # sweep: the host events started by each gap's middle, latest start on
    # top; one that has ended by then has ended for every later gap too
    host = sorted(trace["host"], key=lambda e: e[1])
    running: List[Tuple[int, int, str]] = []
    j = 0
    by_host: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        while j < len(host) and host[j][1] <= mid:
            name, s, d = host[j]
            heapq.heappush(running, (-s, s + d, name))
            j += 1
        while running and running[0][1] <= mid:
            heapq.heappop(running)
        label = running[0][2] if running else "no host operation traced"
        by_host[label] = by_host.get(label, 0.0) + (b - a) / 1e9
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "window_s": trace["window_s"],
            "breakdown": {"device_ops": [[n[:200], s] for n, s in ops], "idle_gaps": [[n[:200], s] for n, s in idle]}}
