"""Share of the traced wave in which no kernel ran on the card."""


def read(record, ctx):
    tr = record.get("trace")
    if record["kind"] != "serve" or tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
