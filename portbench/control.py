#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \\
        --seconds <s> [--fault <name>] [--out <file.jsonl>]

For each seed, one run of the cell (a short window is enough: every wave
runs to its end, every training cell's check follows its first three
steps), then, in the same process:

* the program's readings, as the benchmark compares them (the lower
  reading is their largest over a dozen seeds or more);
* the control's: the plain reference put in the program's place and
  computed in float8 (``reference.common.Prec("fp8")``), the precision
  below the configuration's bfloat16.  Serving reads, at each position of
  the same prompts and served tokens, the gap of the token that the float8
  reference puts first; training follows the same three steps in float8
  and compares them with float32's.  The smallest control reading over
  three seeds or more is the upper reading;
* with ``--fault``, the run is made with that fault of ``faults.py``
  planted in the program, and its readings are a fault's.

One JSON line a seed.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)
for p in (str(HERE.parent / "src"), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def control_readings(out: dict, device) -> dict:
    """The float8 control's readings beside a run's ``execute`` output."""
    import torch

    from portbench import check, generate as gen
    from portbench.reference.common import Prec
    from portbench.weights import make_weights

    rec, ctx = out["_record"], out["_ctx"]
    cfg = ctx.config
    shapes = ctx.param_shapes(ctx.port_model())
    layered = frozenset(cfg["layered"])
    if rec["kind"] == "serve":
        w = make_weights(shapes, cfg["init"], ctx.seed, device,
                         matrix_dtype=cfg["serve"]["weight_dtype"],
                         layered=layered)
        return check.serve_gaps(w, cfg["model"], rec["samples"], device,
                                control=True)
    w = make_weights(shapes, cfg["init"], ctx.seed, device, layered=layered)
    vocab = cfg["model"]["vocab_size"]
    batches = [gen.train_batch(ctx.traffic, vocab, ctx.seed, i, device)
               for i in range(len(rec["reference"]["losses"]))]
    fp8 = check.train_reference(w, cfg["model"], cfg["train"]["opt"], batches,
                                Prec("fp8"))
    del w
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return check.train_readings(fp8, rec["reference"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from portbench import run

    run.set_cache_env()
    import contextlib

    import torch

    from portbench import faults

    torch.set_num_threads(1)
    device = torch.device("cuda")
    for seed in args.seeds:
        t = time.perf_counter()
        planted = (faults.planted(args.fault) if args.fault
                   else contextlib.nullcontext())
        with planted:
            out = run.execute(args.workload, seed, args.seconds, False,
                              t_start=t, keep_ctx=True)
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault, "correct": out["correct"],
                "program": out["_record"]["readings"],
                "failed": out["failed"], "attempted": out["attempted"]}
        if not args.fault:
            line["control"] = control_readings(out, device)
        line["seconds"] = time.perf_counter() - t
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del out
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
