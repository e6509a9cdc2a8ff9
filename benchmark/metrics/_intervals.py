"""Busy time as the union of intervals: overlapping device work (two
streams, or a copy beside a kernel) is counted once, so the busy share can
never pass the window."""

from __future__ import annotations

from typing import Iterable, List, Tuple


def merged(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The intervals' union as disjoint sorted [start, end) pieces."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def union_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    """Length of the union of [start, end) intervals."""
    return sum(b - a for a, b in merged(intervals))


def idle_gaps(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The stretches between the union's pieces, between the first start
    and the last end."""
    m = merged(intervals)
    return [(m[i][1], m[i + 1][0]) for i in range(len(m) - 1)]


def idle_pct(intervals: Iterable[Tuple[int, int]], window_ns: int) -> float:
    """100 x (1 - union / window)."""
    return 100.0 * (1.0 - union_ns(intervals) / window_ns)
