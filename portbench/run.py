#!/usr/bin/env python3
"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs the program (``src/repro_torch``) on the CUDA card(s) of this machine:
set-up (weights from the seed, the cell's warm-up), then a measured window
of ``--seconds``, then the check of what the window produced against the
plain reference in ``portbench/reference``.  Its last line on standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error).  It exits non-zero and prints no result without enough
cards, or if JAX or the JAX package is loaded once the window has closed.
Every build and kernel cache stays under ``build/`` of this checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the script's own folder would shadow the standard library's ``trace``
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CACHE = ROOT / "build" / "portbench_cache"
#: top-level module names that may not be loaded in the measured process
BANNED = ("jax", "jaxlib", "flax", "repro")


def set_cache_env() -> None:
    """Fixed cache directories inside the checkout, no JAX through a library
    that would load it by itself, and one host thread for the CPU's
    operator pools: the engine's host work is one Python thread, and idle
    pools only take cores from it."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"


def banned_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


class Context:
    """What the serving and training code and the metric readers read of one
    run."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device, base: Path, t_start: float):
        from portbench import spec

        self.cell = cell
        self.config = spec.config(cell["config"], base)
        self.traffic = spec.traffic(cell["traffic"], base)
        lim = spec.limits(cell["name"], base)
        self.limits = lim["numbers"]
        self.limits_meta = {k: v for k, v in lim.items() if k != "numbers"}
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start

    def port_model(self):
        """The program's model of this configuration, its sizes held equal
        to the configuration file's."""
        from repro_torch.configs import get_config
        from repro_torch.models import LanguageModel

        port = self.config["port"]
        cfg = get_config(port["name"]).scaled(**port.get("set", {}))
        for attr, key in port["match"].items():
            if getattr(cfg, attr) != self.config["model"][key]:
                raise ValueError(f"the program's {attr} {getattr(cfg, attr)} "
                                 f"is not the file's {key} "
                                 f"{self.config['model'][key]}")
        return LanguageModel(cfg, device=self.device)

    @staticmethod
    def param_shapes(model) -> dict:
        from repro_torch.utils import tree_flatten

        return dict(tree_flatten(model.param_shapes()))

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", root: Path = ROOT, base: Path = HERE,
            t_start: float | None = None, keep_ctx: bool = False) -> dict:
    """One run of ``cell_name``: the result line's fields, and under
    ``_record`` (and with ``keep_ctx`` ``_ctx``) what the run kept."""
    import torch

    from portbench import spec

    bench = spec.benchmark(root)
    cell = spec.cell(bench, cell_name)
    ctx = Context(cell, seed, seconds, trace, torch.device(device), base,
                  T_START if t_start is None else t_start)
    if ctx.traffic["kind"] == "train_batches":
        from portbench import train as workload
    else:
        from portbench import serve as workload
    record = workload.run(ctx)

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(bench, cell_name, section):
        val = spec.reader(m["name"], base)(record, ctx)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}

    from portbench import check

    ok, checks = check.judge(record["readings"], ctx.limits)
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(ctx.device)
                    if ctx.device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]),
           "memory_peak_bytes": record["memory_peak_bytes"]}
    out = {"correct": bool(ok and record["failed"] == 0),
           "attempted": record["attempted"], "failed": record["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        tr = record["trace"]
        if tr is None:
            raise RuntimeError("the profiler's trace held no device event")
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = {**{k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()},
                     "failed_requests": {"value": record["failed"],
                                         "limit": 0}}
    out["_record"] = record
    if keep_ctx:
        out["_ctx"] = ctx
    return out


def _card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_env()

    from portbench import spec

    cell = spec.cell(spec.benchmark(ROOT), args.workload)
    import torch

    torch.set_num_threads(1)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    record = out.pop("_record")
    bad = banned_modules()
    if bad:
        print(f"portbench: the measured process loaded {bad}", file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed}: card {_card_line()}; "
          f"setup {record['setup_s']:.3f} s, window {record['window_s']:.3f} s,"
          f" check {record['check_s']:.3f} s", file=sys.stderr)
    print("setup phases s (from the start, each at its end) "
          f"{json.dumps(record['setup_phases'])}", file=sys.stderr)
    if record["kind"] == "serve":
        walls = [round(w["t1"] - w["t0"], 4) for w in record["waves"]]
        print(f"wave walls s {walls}", file=sys.stderr)
    print(f"readings {json.dumps(record['readings'])}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
