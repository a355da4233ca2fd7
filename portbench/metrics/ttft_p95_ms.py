"""95th percentile (nearest rank), over every request of the window, of the
time from its wave's ``run`` call to its first token reaching the host."""
import math


def read(record, ctx):
    if record["kind"] != "serve" or not record["ttft_s"]:
        return None
    t = sorted(record["ttft_s"])
    return t[math.ceil(0.95 * len(t)) - 1] * 1e3
