"""Phase timers with ray accounting, spans on the device trace's clock, and
a torch.profiler exporter of both.

The port of the JAX package's ``utils/profiling.py``. ``SLAMSystem``
times its parts (track, map, loop, mesh) with a ``PhaseTimer``;
``torch_trace`` wraps a region in a ``torch.profiler`` trace for
TensorBoard, as ``jax_trace`` does with ``jax.profiler``, and writes the
spans recorded under it beside that trace.

Spans name the host work inside the agents (``Mapper.frustum_masks``,
``StepGraph.replay``, ...). ``span(name, **attrs)`` records one while
recording is on: while a ``torch.profiler`` trace runs in the process, or
inside a ``recording()`` block. Off, a span is that one check: it
allocates nothing and reads no clock. A record holds its name, its start
and end in Unix-epoch nanoseconds (``time.time_ns``, the clock of the
kineto events a trace holds, host and device alike), the span it ran
inside on its thread, the thread and a few attributes. Spans are no
``record_function``: those put annotations on the device's timeline,
which a reader of the device's work would count as work.

The recorder keeps the newest ``KEEP`` spans. The outermost ``recording()``
block starts with none; under a bare ``torch.profiler`` the caller owns
clearing them (``take()``), as ``torch_trace`` does.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import socket
import threading
import time
from collections import defaultdict, deque
from typing import Any, Dict, Iterator, List, Optional

import torch

_clock = time.time_ns  # the kineto events' clock (tests/test_torch_tracing.py holds a span against one)
_profiling = torch._C._autograd._profiler_enabled  # torch's own "is a profiler running"
_explicit = 0  # open recording() blocks
KEEP = 1 << 16  # spans kept, the newest: some hundred traced cycles
_records: "deque[Span]" = deque(maxlen=KEEP)
_lock = threading.Lock()
_local = threading.local()


class Span:
    """One recorded span; its own context manager. ``parent``: the span it
    ran inside on the same thread (None for a root); ``tid``: the thread's
    native id (the trace's); ``attrs``: small values (a frame index, a
    stage, an iteration count, a counter's value)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "tid", "attrs")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.start_ns = self.end_ns = 0
        self.parent: Optional[Span] = None
        self.tid = 0

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.tid = threading.get_native_id()
        stack.append(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = _clock()
        _local.stack.pop()
        with _lock:
            _records.append(self)
        return False


class _Off:
    """The context manager of a span while recording is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, **attrs: Any):
    """A context manager around host work named ``name`` (``Class.part``);
    ``with span(...) as s`` gives the record, or None while off, so a
    caller may add attributes it learns inside."""
    if not (_explicit or _profiling()):
        return _OFF
    return Span(name, attrs)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside this block, with or without a profiler; the
    outermost block starts with no spans recorded."""
    global _explicit
    with _lock:
        if not _explicit:
            _records.clear()
        _explicit += 1
    try:
        yield
    finally:
        with _lock:
            _explicit -= 1


def spans() -> List[Span]:
    """The spans recorded so far, by start; kept for the next reader."""
    with _lock:
        return sorted(_records, key=lambda s: s.start_ns)


def take() -> List[Span]:
    """The spans recorded so far, by start; cleared (for exporters)."""
    with _lock:
        out = sorted(_records, key=lambda s: s.start_ns)
        _records.clear()
    return out


def children(parent: Span, records: List[Span]) -> List[Span]:
    return [s for s in records if s.parent is parent]


def self_ns(parent: Span, records: List[Span]) -> int:
    """``parent``'s duration less what its children among ``records``
    cover (their union, clipped to it)."""
    covered, end = 0, parent.start_ns
    for s in sorted(children(parent, records), key=lambda s: s.start_ns):
        a, b = max(s.start_ns, end), min(s.end_ns, parent.end_ns)
        if b > a:
            covered += b - a
            end = b
    return parent.duration_ns - covered


def _chrome_events(records: List[Span], base_ns: int = 0) -> List[Dict[str, Any]]:
    """Complete events ("X") of Chrome's trace format, in microseconds from
    ``base_ns`` (a kineto trace's ``baseTimeNanoseconds``), on this
    process's id and each span's thread."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.tid,
             "ts": (s.start_ns - base_ns) / 1e3, "dur": s.duration_ns / 1e3,
             "args": {k: v if isinstance(v, (int, float, str, bool)) else str(v) for k, v in s.attrs.items()}}
            for s in records]


def _kineto_base_ns(path: str) -> int:
    """The ``baseTimeNanoseconds`` a kineto trace file states in its head
    (its events' ``ts`` count from it), 0 where it states none."""
    with open(path, "rb") as f:
        head = f.read(1 << 16).decode("utf-8", "replace")
    m = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
    return int(m.group(1)) if m else 0


class PhaseTimer:
    """Accumulating wall-clock timer with ray accounting per phase. Phases
    may run on several threads at once (the async modes' tracker and
    mapper); each adds its own wall time under a lock, so two phases that
    overlap both count the overlap. Each phase is also a span of its
    name."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.rays: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str, rays: int = 0) -> Iterator[None]:
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.seconds[name] += dt
                    self.counts[name] += 1
                    self.rays[name] += rays

    def rays_per_s(self, name: str) -> float:
        s = self.seconds.get(name, 0.0)
        return self.rays.get(name, 0) / s if s > 0 else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "seconds": round(self.seconds[k], 3),
                "calls": self.counts[k],
                "rays": self.rays[k],
                "rays_per_s": round(self.rays_per_s(k), 1),
            }
            for k in self.seconds
        }

    def dump(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.summary(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s


@contextlib.contextmanager
def torch_trace(logdir: Optional[str], worker: Optional[str] = None) -> Iterator[None]:
    """Wrap a region in a torch.profiler trace for TensorBoard (CPU
    activity, and CUDA's when a card is present), with spans recorded.
    The trace goes to ``<logdir>/<worker>.<ns>.pt.trace.json`` and the
    spans recorded under it to ``<worker>.<ns>.spans.json`` beside it, in
    Chrome's trace format on the trace's own time base, so that a viewer
    (Perfetto, TensorBoard's trace viewer) places them on the trace's
    timeline. ``worker`` defaults to ``<host>_<pid>``, so the ranks of a
    ``torchrun`` each write their own pair into one ``logdir``. No-op when
    ``logdir`` is None."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    stem = os.path.join(logdir, f"{worker or f'{socket.gethostname()}_{os.getpid()}'}.{_clock()}")
    trace = f"{stem}.pt.trace.json"
    os.makedirs(logdir, exist_ok=True)
    with recording(), profile(activities=activities, on_trace_ready=lambda p: p.export_chrome_trace(trace)):
        yield
    base = _kineto_base_ns(trace)
    with open(f"{stem}.spans.json", "w") as f:
        json.dump({"displayTimeUnit": "ms", "baseTimeNanoseconds": base,
                   "traceEvents": _chrome_events(take(), base)}, f)
