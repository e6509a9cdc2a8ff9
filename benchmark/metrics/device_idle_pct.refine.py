"""The device's idle share of the traced window, in the refine cell
(``benchmark/metrics/_trace.py:idle_pct``)."""

from benchmark.metrics._trace import idle_pct as read  # noqa: F401
