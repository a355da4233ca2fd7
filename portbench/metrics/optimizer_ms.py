"""Device time of the kernels that start inside the harness's span around
``AdamW.update`` (bracketed by synchronisations in the traced steps), per
step."""


def read(record, ctx):
    tr = record.get("trace")
    if record["kind"] != "train" or tr is None:
        return None
    spans = [(s, e) for n, s, e in tr.spans
             if n == "optimizer" and tr.t0 <= s and e <= tr.t1]
    if not spans:
        return None
    t = sum(tr.device_time_s(s, e) for s, e in spans)
    return t / len(spans) * 1e3 if t > 0 else None
