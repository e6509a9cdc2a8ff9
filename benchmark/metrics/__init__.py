"""Metric readers (``<name>.py``, each a ``read(record)``) and the arithmetic
they share (``_*.py``)."""
