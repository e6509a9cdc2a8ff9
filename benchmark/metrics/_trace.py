"""Sums over a trace's device events (name, start ns, duration ns), and the
device's idle share of a traced window."""

from typing import Iterable, Tuple

from benchmark.metrics._kernels import is_kernel

NOT_KERNELS = ("Memcpy", "Memset")


def kernel_count(events: Iterable[Tuple[str, int, int]]) -> int:
    return sum(1 for name, _, _ in events if not name.startswith(NOT_KERNELS))


def kernel_time(events, names) -> Tuple[int, float]:
    """(launches, device seconds) of the kernels whose function is in ``names``."""
    hits = [d for name, _, d in events if is_kernel(name, names)]
    return len(hits), sum(hits) / 1e9


def idle_pct(record):
    """The device's idle share of the traced window: 1 - (union of the
    device operations' intervals) / (the window's host-clock length), in %;
    None without a trace."""
    t = record.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
