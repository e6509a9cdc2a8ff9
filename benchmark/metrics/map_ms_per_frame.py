"""Host-clock milliseconds in Mapper.optimize_map (which ends synchronised)
over the window, per frame of the sequence."""


def read(record):
    w = record["window"]
    return 1e3 * sum(w["map_s"]) / w["frames"]
