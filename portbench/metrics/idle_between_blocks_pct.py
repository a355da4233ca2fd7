"""Share (%) of the traced window (``idle_pct.serve``'s base) in which no
kernel ran on the card while the paged engine's host was in
``drain.unpack``, ``admit`` or ``decode.block``: from a drain's wait to
the next prefill round, the card waiting on the host's scheduling."""
from portbench.metrics._engine_spans import idle_pct_inside


def read(record, ctx):
    return idle_pct_inside(record, {"drain.unpack", "admit", "decode.block"})
