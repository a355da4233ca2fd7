"""Device time of a prefill round's KV view: the median, over the window's
rounds, of the paged engine's ``kv.gather`` + ``kv.scatter`` spans'
``device_ms`` (CUDA events on the working stream around
``PagedKVCache._gather_impl`` with the table lookup, and around
``_scatter_impl``), in ms."""
from portbench.metrics._engine_spans import median_round_ms


def read(record, ctx):
    return median_round_ms(record, ("kv.gather", "kv.scatter"))
