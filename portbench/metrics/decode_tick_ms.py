"""The engine's own ``tick_ms_p50`` (a decode block's wall over its ticks,
the median over its blocks), the median over the window's waves."""
import statistics


def read(record, ctx):
    if record["kind"] != "serve":
        return None
    vals = [w["stats"]["tick_ms_p50"] for w in record["waves"]
            if w["stats"]["decode_ticks"]]
    return statistics.median(vals) if vals else None
