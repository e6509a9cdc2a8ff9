"""Full frames rendered over the whole window."""


def read(record):
    w = record["window"]
    return w["frames"] / w["seconds"]
