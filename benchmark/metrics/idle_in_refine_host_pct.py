"""The device's idle time inside the final refine's host work between one
entry's replays and the next's, in % of the traced window: the
``LoopCloser.frame_in`` (the frame read and copied to the card) and
``LoopCloser.pose_to_host`` (the wait for the pose, its clamp) spans less
the union of the device's operations, over ``window_s``. The spans and the
device events share the kineto clock."""

from benchmark.metrics._spans import traced_spans, uncovered_ns

HOST_WORK = ("LoopCloser.frame_in", "LoopCloser.pose_to_host")


def read(record):
    t = record.get("trace")
    spans = traced_spans(record)
    if not spans or not t["device"] or t["window_s"] <= 0:
        return None
    host = [(s, e) for n, s, e, _ in spans if n in HOST_WORK]
    if not host:
        return None
    idle = uncovered_ns(host, [(s, s + d) for _, s, d in t["device"]])
    return 100.0 * idle / 1e9 / t["window_s"]
