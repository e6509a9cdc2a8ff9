"""The program's spans in a traced run (``attentive_dfprior_tpu_torch/
utils/profiling.py``), read from its recorder in the process that ran the
cell: the record carries none. The recorder records only while a profiler
runs, and the traced unit is the only thing that runs under one, so its
spans are the traced unit's; those of an earlier traced run in the same
process (the CPU tests run several) lie before the trace's device events
and are left out. Where the program has no recorder, as before it had
one, every reader finds nothing and returns None."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from benchmark.metrics._intervals import merged

Record = Tuple[str, int, int, Dict[str, Any]]  # name, start ns, end ns, attributes


def traced_spans(record) -> Optional[List[Record]]:
    """The traced unit's spans by start, or None: no trace, no recorder in
    the program, or no span."""
    t = record.get("trace")
    if not t:
        return None
    try:
        from attentive_dfprior_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    out = [(s.name, s.start_ns, s.end_ns, dict(s.attrs)) for s in read()]
    device = t.get("device") or []
    if device:
        lo = min(s for _, s, _ in device)
        hi = max(s + d for _, s, d in device)
        out = [r for r in out if r[2] >= lo and r[1] <= hi]
    return out or None


def durations_ns(spans: Sequence[Record], name: str) -> List[int]:
    return [e - s for n, s, e, _ in spans if n == name]


def count(spans: Sequence[Record], name: str) -> int:
    return sum(1 for r in spans if r[0] == name)


def uncovered_ns(pieces: Sequence[Tuple[int, int]], busy: Sequence[Tuple[int, int]]) -> int:
    """The length of the union of ``pieces`` that no interval of ``busy``
    covers (both lists of [start, end) intervals)."""
    busy = merged(busy)
    total, j = 0, 0
    for a, b in merged(pieces):
        total += b - a
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            total -= min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return total
