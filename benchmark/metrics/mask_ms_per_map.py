"""Host milliseconds in the frustum masks (``Mapper.frustum_masks``: the
masks in numpy and their copy to the card) per ``Mapper.optimize_map`` of
the traced cycle."""

from benchmark.metrics._spans import count, durations_ns, traced_spans


def read(record):
    spans = traced_spans(record)
    masks = durations_ns(spans or [], "Mapper.frustum_masks")
    maps = count(spans or [], "Mapper.optimize_map")
    if not masks or not maps:
        return None
    return sum(masks) / 1e6 / maps
