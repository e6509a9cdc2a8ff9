"""Frames tracked (and mapped where scheduled) over the whole window, whole cycles only."""


def read(record):
    w = record["window"]
    return w["frames"] / w["seconds"]
