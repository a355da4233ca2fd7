"""Prompt and generated tokens of every request served in the window, over
the window's wall (whole waves)."""


def read(record, ctx):
    if record["kind"] != "serve":
        return None
    return sum(p + o for p, o in record["served"]) / record["window_s"]
