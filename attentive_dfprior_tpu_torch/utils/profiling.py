"""Phase timers with ray accounting, and torch.profiler regions.

The port of the JAX package's ``utils/profiling.py``. ``SLAMSystem``
times its parts (track, map, loop, mesh) with a ``PhaseTimer``;
``torch_trace`` wraps a region in a ``torch.profiler`` trace for
TensorBoard, as ``jax_trace`` does with ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class PhaseTimer:
    """Accumulating wall-clock timer with ray accounting per phase. Phases
    may run on several threads at once (the async modes' tracker and
    mapper); each adds its own wall time under a lock, so two phases that
    overlap both count the overlap."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.rays: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str, rays: int = 0) -> Iterator[None]:
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
def torch_trace(logdir: Optional[str]) -> Iterator[None]:
    """Wrap a region in a torch.profiler trace written to ``logdir`` for
    TensorBoard (CPU activity, and CUDA's when a card is present); no-op
    when ``logdir`` is None."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
