"""Serving: the program's paged engine under waves of requests.

Set-up builds one ``PagedServingEngine`` (the program's production path)
over weights made from the seed, and runs the warm-up wave through it.
The window then hands the engine the mix's waves, one ``run`` call each,
until ``--seconds`` have passed; each wave begun runs to its end.  Each
request's ``out`` is a ``StampedList``, which notes the host clock the
first time the engine's drain adds tokens to it: its first token reaching
the host.  No program code is patched.
"""
from __future__ import annotations

import gc
import time

from portbench import check, generate as gen
from portbench.trace import Spans, Tracer
from portbench.weights import make_weights, nest

#: seconds of a traced wave under the profiler: reading the trace of a whole
#: granite-moe.serve.short wave (45 s, about a million kernels) took 230-270
#: s on the card, and a run has 360 s in all
TRACE_S = 30.0


class StampedList(list):
    """A request's output list that notes when its first tokens arrive.
    With a ``tracer``, each drain that reaches it also lets the tracer stop
    once its time is up (on the engine's own thread, between blocks)."""

    def __init__(self, tracer: Tracer | None = None):
        super().__init__()
        self.t_first: float | None = None
        self.tracer = tracer

    def _stamp(self, items: list) -> None:
        if items and self.t_first is None:
            self.t_first = time.perf_counter()
        if self.tracer is not None:
            self.tracer.poll()

    def extend(self, items) -> None:
        items = list(items)
        self._stamp(items)
        super().extend(items)

    def append(self, item) -> None:
        self._stamp([item])
        super().append(item)


def _requests(pairs, Request, rid0: int = 0, tracer=None) -> list:
    return [Request(rid=rid0 + i, prompt=p, max_new=n,
                    out=StampedList(tracer))
            for i, (p, n) in enumerate(pairs)]


def run(ctx) -> dict:
    import torch

    from repro_torch.launch.serve import PagedServingEngine, Request

    phases = {"imports": time.perf_counter() - ctx.t_start}

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    vocab = cfg["model"]["vocab_size"]
    model = ctx.port_model()
    serve = cfg["serve"]
    engine_kw = {**serve["engine"], **tr.get("engine", {})}

    def weights():
        return make_weights(ctx.param_shapes(model), cfg["init"], ctx.seed,
                            dev, matrix_dtype=serve["weight_dtype"],
                            layered=frozenset(cfg["layered"]))

    phases["model"] = time.perf_counter() - ctx.t_start
    params = nest(weights())
    ctx.sync()
    phases["weights"] = time.perf_counter() - ctx.t_start
    engine = PagedServingEngine(model, params, **engine_kw)
    del params
    phases["engine"] = time.perf_counter() - ctx.t_start
    engine.run(_requests(gen.warmup_wave(tr, engine_kw, vocab, ctx.seed),
                         Request))
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start
    phases["warmup"] = setup_s

    spans = Spans()
    waves, trace = [], None
    window_s = 0.0  # the waves' walls: the trace's reading is left out
    while not waves or window_s < ctx.seconds:
        k = len(waves)
        tracer = (Tracer(spans, ctx.sync, TRACE_S)
                  if ctx.trace and trace is None else None)
        reqs = _requests(gen.wave(tr, vocab, ctx.seed, k), Request,
                         rid0=k * tr["requests"], tracer=tracer)
        with spans.span(f"wave {k}"):
            if tracer is not None:
                tracer.start()
            tw = time.perf_counter()
            stats = engine.run(reqs)
            if tracer is not None:
                tracer.stop()
            te = time.perf_counter()
        skip = 0.0
        if tracer is not None:
            skip = tracer.trace.overhead_s  # reading the trace is not serving
            if tracer.trace.kernels:  # an empty trace: take the next wave's
                trace = tracer.trace
        waves.append({"t0": tw, "t1": te, "stats": stats, "requests": reqs})
        window_s += te - tw - skip
    peak = ctx.memory_peak()

    done = [r for w in waves for r in w["requests"]]
    failed = sum(r.rejected or len(r.out) != r.max_new or r.out.t_first is None
                 for r in done)
    ttft = sorted((r.out.t_first - w["t0"]) for w in waves
                  for r in w["requests"] if r.out.t_first is not None)
    record = {
        "kind": "serve", "setup_s": setup_s, "setup_phases": phases,
        "window_s": window_s,
        "waves": [{"t0": w["t0"], "t1": w["t1"], "stats": w["stats"]}
                  for w in waves],
        "served": [(len(r.prompt), len(r.out)) for r in done
                   if not r.rejected],
        "ttft_s": ttft, "trace": trace, "attempted": len(done),
        "failed": failed, "memory_peak_bytes": peak,
    }

    # correctness, once the window has closed and the program is freed
    rng = gen.seeded(ctx.seed, 4)
    n = min(ctx.limits_meta.get("check_requests", 8), len(done))
    longest = max(range(len(done)),
                  key=lambda i: len(done[i].prompt) + len(done[i].out))
    rest = [i for i in range(len(done)) if i != longest]
    pick = [longest] + sorted(rng.choice(rest, size=n - 1, replace=False)
                              .tolist()) if n > 1 else [longest]
    samples = [(list(done[i].prompt), list(done[i].out)) for i in pick]
    del engine, done, waves
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    record["readings"] = check.serve_gaps(weights(), cfg["model"], samples,
                                          dev)
    record["check_s"] = time.perf_counter() - t
    record["samples"] = samples
    return record
