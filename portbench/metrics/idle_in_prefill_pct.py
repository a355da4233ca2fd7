"""Share (%) of the traced window (``idle_pct.serve``'s base) in which no
kernel ran on the card while the paged engine's host was inside a
``prefill.round`` span: the card waiting on a prefill round's host work."""
from portbench.metrics._engine_spans import idle_pct_inside


def read(record, ctx):
    return idle_pct_inside(record, {"prefill.round"})
