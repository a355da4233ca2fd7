"""Model FLOPs of the window's requests (each prompt's forward and a decode
step for each generated token after the first; active experts only) over
the window's wall and the card's bf16 peak, in percent."""
from portbench import arith


def read(record, ctx):
    if record["kind"] != "serve":
        return None
    m = ctx.config["model"]
    flops = sum(arith.request_flops(m, p, o) for p, o in record["served"])
    return 100.0 * flops / record["window_s"] / arith.PEAK_BF16_FLOPS
