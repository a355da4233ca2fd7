"""Batched serving example on the port: continuous batching over decode
slots.  The port's copy of ``examples/serve_lm.py``, with the same
arguments and output, plus ``--device`` (default ``cuda``) and ``--width``:
``smoke`` (the default, as the reference) serves the arch's smoke config,
``full`` its full width with seed-0 random weights in the config's compute
dtype (bf16).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch gemma-2b --requests 6
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import argparse
import importlib

import numpy as np

from repro_torch.launch.serve import ContinuousBatcher, Request
from repro_torch.models import LanguageModel


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", choices=("smoke", "full"), default="smoke")
    args = ap.parse_args()

    mod = importlib.import_module(
        "repro_torch.configs." + args.arch.replace("-", "_").replace(".", "_"))
    cfg = mod.smoke() if args.width == "smoke" else mod.config()
    model = LanguageModel(cfg, device=args.device)
    params = model.init(0)

    batcher = ContinuousBatcher(model, params, n_slots=args.slots,
                                max_len=64)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i,
                    prompt=rng.randint(0, cfg.vocab_size, 6).tolist(),
                    max_new=args.max_new)
            for i in range(args.requests)]
    stats = batcher.run(reqs)
    print(f"[serve {args.arch}] {stats['requests']} requests, "
          f"{stats['tokens']} tokens in {stats['wall_s']:.2f}s "
          f"({stats['tok_per_s']:.1f} tok/s, {stats['ticks']} ticks, "
          f"{args.slots} slots)")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt {r.prompt} -> out {r.out}")


if __name__ == "__main__":
    main()
