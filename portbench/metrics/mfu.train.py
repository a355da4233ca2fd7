"""Model FLOPs of the window's steps (forward and backward, active experts
only, no recomputation) over the window's wall and the card's bf16 peak,
in percent."""
from portbench import arith


def read(record, ctx):
    if record["kind"] != "train":
        return None
    m, tr = ctx.config["model"], ctx.traffic
    flops = record["steps"] * arith.train_step_flops(m, tr["batch"], tr["seq"])
    return 100.0 * flops / record["window_s"] / arith.PEAK_BF16_FLOPS
