"""Device time of a prefill round's model call: the median, over the
window's rounds, of the paged engine's ``model.prefill_chunk`` span's
``device_ms`` (CUDA events around ``LanguageModel.prefill_chunk``), in
ms."""
from portbench.metrics._engine_spans import median_round_ms


def read(record, ctx):
    return median_round_ms(record, ("model.prefill_chunk",))
