"""Rate of a prefill round's KV view: the engine's ``kv_view_bytes`` (each
byte a round's gather and scatter must read or write, counted once, from
the view's shapes) over the ``kv.gather`` + ``kv.scatter`` spans'
``device_ms``, summed over the window's rounds that have both, in GB/s
(the card's HBM peak: 3,350 GB/s)."""
from portbench.metrics._engine_spans import round_device_ms, waves


def read(record, ctx):
    nbytes = ms = 0.0
    for stats, spans in waves(record):
        timed = round_device_ms(spans, ("kv.gather", "kv.scatter"))
        if timed and stats["prefill_rounds"]:
            nbytes += (stats["kv_view_bytes"] / stats["prefill_rounds"]
                       * len(timed))
            ms += sum(timed)
    return nbytes / (ms / 1e3) / 1e9 if ms > 0 else None
