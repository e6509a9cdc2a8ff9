"""Host-clock milliseconds in Tracker.track (which ends with the pose on the
host) over the window, per frame."""


def read(record):
    w = record["window"]
    return 1e3 * sum(w["track_s"]) / w["frames"]
