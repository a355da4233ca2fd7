"""The decode graph's own time a tick: the median, over the window's decode
blocks, of the paged engine's ``decode.block`` span's ``device_ms`` (CUDA
events around the graph's replay) over the block's ticks
(``drain_every``), in ms; ``decode_tick_ms`` is the same block's wall on
the host, prefill work queued behind it included."""
import statistics

from portbench.metrics._engine_spans import waves


def read(record, ctx):
    vals = []
    for stats, spans in waves(record):
        blocks = [s.device_ms for s in spans if s.name == "decode.block"]
        if not blocks:
            continue
        ticks = stats["decode_ticks"] / len(blocks)
        vals += [ms / ticks for ms in blocks if ms is not None]
    return statistics.median(vals) if vals else None
