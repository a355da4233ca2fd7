"""The engine's ``prefill_rounds`` counter summed over the window's waves,
over the number of waves."""


def read(record, ctx):
    if record["kind"] != "serve":
        return None
    waves = record["waves"]
    return sum(w["stats"]["prefill_rounds"] for w in waves) / len(waves)
