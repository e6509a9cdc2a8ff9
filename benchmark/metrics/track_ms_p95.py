"""95th percentile, over every frame of the window, of the time from handing
the frame to Tracker.track to its pose on the host."""

import numpy as np


def read(record):
    return float(np.percentile(np.asarray(record["window"]["track_s"]) * 1e3, 95))
