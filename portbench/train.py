"""Training: the program's train step, back to back.

Set-up builds one train step (``repro_torch.launch.train.make_train_step``
over the program's ``AdamW``), with float32 masters made from the seed,
and drives it through its first three steps on the seed's batches: those
steps are what the reference follows.  The same step, weights and moments
then run the window: whole steps until ``--seconds`` have passed, ended by
a synchronisation.  The optimizer's ``update`` is wrapped, on this
instance only, in a harness span; in a traced step the span is bracketed
by synchronisations, so the kernels that start inside it are the
optimizer's.
"""
from __future__ import annotations

import gc
import time

from portbench import check, generate as gen
from portbench.reference.common import Prec
from portbench.trace import Spans, traced
from portbench.weights import make_weights, nest

CHECK_STEPS = 3


def run(ctx) -> dict:
    import torch

    from repro_torch.launch.train import make_train_step
    from repro_torch.optim.adamw import AdamW, OptConfig
    from repro_torch.utils import tree_flatten

    phases = {"imports": time.perf_counter() - ctx.t_start}

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    vocab = cfg["model"]["vocab_size"]
    model = ctx.port_model()
    optcfg = cfg["train"]["opt"]
    opt = AdamW(OptConfig(**optcfg))
    spans = Spans()
    tracing = {"on": False}
    update = opt.update

    def spanned_update(*args, **kw):
        if tracing["on"]:
            ctx.sync()
        with spans.span("optimizer"):
            out = update(*args, **kw)
            if tracing["on"]:
                ctx.sync()
        return out

    opt.update = spanned_update
    phases["model"] = time.perf_counter() - ctx.t_start
    shapes = ctx.param_shapes(model)
    layered = frozenset(cfg["layered"])
    params = nest(make_weights(shapes, cfg["init"], ctx.seed, dev,
                               layered=layered))
    state = opt.init(params)
    step = make_train_step(model, opt)
    ctx.sync()
    phases["weights"] = time.perf_counter() - ctx.t_start
    b1 = optcfg["b1"]

    def leaf_norms(tree, scale=1.0):
        return {k: float(t.norm()) * scale for k, t in tree_flatten(tree)}

    losses = []
    grad_norms = None
    for i in range(CHECK_STEPS):
        params, state, m = step(params, state,
                                gen.train_batch(tr, vocab, ctx.seed, i, dev))
        losses.append(m["loss"])
        if i == 0:  # m = (1 - b1) c g after one step
            grad_norms = leaf_norms(state["m"], 1.0 / (1 - b1))
    start = make_weights(shapes, cfg["init"], ctx.seed, dev, layered=layered)
    change = {k: float((t.detach() - start[k]).norm())
              for k, t in tree_flatten(params)}
    del start
    prog = {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "change_norms": change}
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start
    phases["check_steps"] = setup_s

    batches = [gen.train_batch(tr, vocab, ctx.seed, CHECK_STEPS + j, dev)
               for j in range(2)]
    n_steps, trace, overhead = 0, None, 0.0
    t0 = time.perf_counter()
    while not n_steps or time.perf_counter() - t0 - overhead < ctx.seconds:
        batch = batches[n_steps % 2]
        if ctx.trace and trace is None:
            def two():
                nonlocal params, state
                for _ in range(2):
                    with spans.span("step"):
                        params, state, _ = step(params, state, batch)
                return None

            tracing["on"] = True
            _, trace = traced(two, spans, ctx.sync)
            tracing["on"] = False
            overhead += trace.overhead_s  # reading the trace is not training
            n_steps += 2
            if not trace.kernels:
                trace = None
            continue
        params, state, _ = step(params, state, batch)
        n_steps += 1
    ctx.sync()
    window_s = time.perf_counter() - t0 - overhead
    peak = ctx.memory_peak()
    record = {
        "kind": "train", "setup_s": setup_s, "setup_phases": phases,
        "window_s": window_s,
        "steps": n_steps, "tokens_per_step": tr["batch"] * tr["seq"],
        "trace": trace, "attempted": n_steps,
        "failed": 0, "memory_peak_bytes": peak,
    }

    del params, state, step, opt, batches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    w = make_weights(shapes, cfg["init"], ctx.seed, dev, layered=layered)
    refr = check.train_reference(
        w, cfg["model"], {**optcfg}, [gen.train_batch(tr, vocab, ctx.seed, i,
                                                      dev)
                                      for i in range(CHECK_STEPS)],
        Prec("f32"))
    record["readings"] = check.train_readings(prog, refr)
    record["program"], record["reference"] = prog, refr
    record["check_s"] = time.perf_counter() - t
    return record
