"""Tokens trained in the window (whole steps) over its wall, which ends in a
synchronisation."""


def read(record, ctx):
    if record["kind"] != "train":
        return None
    return record["steps"] * record["tokens_per_step"] / record["window_s"]
