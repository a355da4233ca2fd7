"""The WKV kernels' share of their roofline over the traced wave: the least
time of the scans that wave's prompts need (``arith.wkv_bound_s``: every
prompt token through every layer, each sequence's state written once a
layer) over the device time of the kernels named ``wkv_`` in it.  A trace
cut by its time limit before its wave ended holds only part of the wave's
scans, so it gives no reading."""
from portbench import arith, generate


def read(record, ctx):
    tr = record.get("trace")
    if record["kind"] != "serve" or tr is None or tr.cut:
        return None
    device = tr.device_time_s(tr.t0, tr.t1, ("wkv_",))
    if device <= 0:
        return None
    w = generate.wave_stats(ctx.traffic)
    bound = arith.wkv_bound_s(ctx.config["model"], w["prompt_tokens"],
                              w["requests"])
    return 100.0 * bound / device
