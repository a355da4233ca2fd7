"""Run a snippet of the port on N ranks, each its own process.

``run_ranks(body, world, tmp_path)`` writes ``body`` after a prelude that
starts rank ``RANK`` of a ``world``-rank gloo group (``backend="nccl"``:
one card a rank, ``DEVICE`` "cuda") through
``repro_torch.launch.mesh`` with a ``file://`` rendezvous under
``tmp_path`` (so concurrent tests never share a port), runs one process per
rank, and returns what rank 0 passed to ``emit(name, **arrays)``:
``{name: {key: array}}``.  The children import ``repro_torch`` and this
module only (never JAX); arrays the body needs come in through ``tmp_path``
(``DIR``).  ``sharded_vs_unsharded`` is the children's one comparison of a
run on a mesh against the unsharded run; it runs the mesh side under
``no_strided_views``, so a fold that only newer torch versions can make
fails here as it fails on the cards.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

PRELUDE = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.launch.mesh import init_process_group, small_mesh_info
from _torch_dist import sharded_vs_unsharded

RANK, WORLD, DIR = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
BACKEND = sys.argv[4]
DEVICE = "cuda" if BACKEND == "nccl" else "cpu"
torch.set_num_threads(1)
init_process_group(BACKEND, "file://" + os.path.join(DIR, "pg_rendezvous"),
                   rank=RANK, world_size=WORLD)


def emit(name, **arrays):
    if RANK == 0:
        np.savez(os.path.join(DIR, "out_" + name + ".npz"), **arrays)


"""


def run_ranks(body: str, world: int, tmp_path, timeout: float = 180.0,
              backend: str = "gloo") -> dict:
    d = Path(tmp_path)
    for f in d.glob("out_*.npz"):
        f.unlink()
    rv = d / "pg_rendezvous"
    if rv.exists():
        rv.unlink()
    script = d / "ranks.py"
    script.write_text(PRELUDE + textwrap.dedent(body)
                      + "\ndist.destroy_process_group()\n")
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    logs = [open(d / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world),
                               str(d), backend], stdout=logs[r],
                              stderr=subprocess.STDOUT, env=env, cwd=ROOT)
             for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tails = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        tails.append(f"--- rank {r} rc={p.returncode}\n{log.read()[-3000:]}")
        log.close()
    assert all(p.returncode == 0 for p in procs), "\n".join(tails)
    out = {}
    for f in d.glob("out_*.npz"):
        with np.load(f) as z:
            out[f.stem[4:]] = {k: z[k] for k in z.files}
    return out


@contextlib.contextmanager
def no_strided_views():
    """Fail any DTensor op whose result is laid out as a strided shard: the
    layout of a fold that puts a split dim behind another (a (batch, seq)
    split over (data, model) viewed as one dim).  Torch 2.11's DTensor
    cannot make that view and stops (ROADMAP §3, fault 3); newer versions
    make it, so without this guard a CPU run on a newer torch passes where
    the cards' torch fails."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import placement_types

    strided = getattr(placement_types, "_StridedShard", None)
    dispatcher = type(DTensor._op_dispatcher)
    wrap = dispatcher.__dict__.get("wrap")
    if strided is None or not isinstance(wrap, staticmethod):
        yield  # a torch without the layout, or another dispatcher
        return

    def guarded(res, spec):
        for sp in spec if isinstance(spec, (list, tuple)) else [spec]:
            if sp is not None and any(isinstance(p, strided)
                                      for p in sp.placements):
                raise RuntimeError(f"a DTensor op laid its result out as {sp}:"
                                   " a fold of a split dim behind another")
        return wrap.__func__(res, spec)

    dispatcher.wrap = staticmethod(guarded)
    try:
        yield
    finally:
        dispatcher.wrap = wrap


def sharded_vs_unsharded(model, params, batch, info, which="total_loss",
                         reference=None, layouts=None) -> dict:
    """The loss ``which`` (a key of ``train_loss``'s metrics) and its
    gradients from ``params`` and ``batch``, unsharded and then on ``info``'s
    mesh (parameters laid out by ``param_axes``, each batch key by its entry
    in ``layouts``, else as ``("batch", "seq_act")``: whisper's ``frames``
    take ``("batch", "seq_act", None)``, as JAX's ``specs.py:34-36``).
    ``reference(params, batch)``, where given, is the
    unsharded loss instead.  Returns arrays for ``emit``: ``loss``
    (unsharded, sharded), ``grad_err`` (each leaf's max |sharded -
    unsharded| over its max |unsharded|), ``calls`` (the MoE paths on the
    mesh: dense, shard_map) and ``device`` (the sharded leaves' type)."""
    import torch

    from repro_torch.distributed.sharding import distribute_tree, use_mesh_info
    from repro_torch.models import moe
    from repro_torch.utils import tree_leaves, tree_map

    if reference is None:
        def reference(p, b):
            return model.train_loss(p, b)[1][which]
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    ref = reference(params, batch)
    ref_grads = torch.autograd.grad(ref, leaves)
    with use_mesh_info(info), no_strided_views():
        moe.PATH_CALLS.update(dense=0, shard_map=0)
        dp = distribute_tree(tree_map(lambda t: t.detach(), params),
                             model.param_axes, info)
        dl = [p.requires_grad_(True) for p in tree_leaves(dp)]
        db = {k: info.distribute(v, (layouts or {}).get(k, ("batch",
                                                            "seq_act")))
              for k, v in batch.items()}
        loss = model.train_loss(dp, db)[1][which]
        grads = torch.autograd.grad(loss, dl)
        err = [float((a.full_tensor() - b).abs().max()
                     / b.abs().max().clamp(min=1e-30))
               for a, b in zip(grads, ref_grads)]
    return {"loss": np.array([float(ref.detach()),
                              float(loss.detach().full_tensor())]),
            "grad_err": np.array(err),
            "calls": np.array([moe.PATH_CALLS["dense"],
                               moe.PATH_CALLS["shard_map"]]),
            "device": np.array(dl[0].device.type)}


def serve_sharded_vs_unsharded(model, params, batch, info, follow,
                               max_len, layouts=None, chunk=0) -> dict:
    """``prefill`` of ``batch`` then one ``decode_step`` per column of
    ``follow`` ((B, steps) tokens, given so that both runs decode the same
    tokens), unsharded and then on ``info``'s mesh: parameters laid out by
    ``param_axes``, the cache by its specs' axes (taken under the mesh, as
    the dry run lays it out), each batch key by its entry in ``layouts``,
    else ``("batch", "seq_act")``, decode tokens ``("batch", None)`` and
    positions ``("batch",)`` (``launch/specs.py``).  ``chunk`` > 0 prefills
    all but the last ``chunk`` tokens, then those through
    ``prefill_chunk`` (its start ``("batch",)``).  The mesh side runs under
    ``no_strided_views``.  Returns arrays for ``emit``: ``logits``
    (unsharded, sharded), (2, calls, B, vocab), one a call in order;
    ``calls`` (the kernel wrappers' calls on the mesh: flash, linear_scan),
    ``launches`` (the kernels' launch counts there) and ``local`` (whether
    every wrapper call on the mesh got plain tensors)."""
    import torch

    from repro_torch.distributed.sharding import (distribute_tree, is_dtensor,
                                                  use_mesh_info)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import ops as kops
    from repro_torch.utils import tree_map

    B, S = batch["tokens"].shape
    enc_len = batch["frames"].shape[1] if "frames" in batch else 0
    head = {k: v[:, :S - chunk] if k == "tokens" else v
            for k, v in batch.items()}

    def run(p, cache, place):
        def lay(b):
            return {k: place(v, (layouts or {}).get(k, ("batch", "seq_act")))
                    for k, v in b.items()}

        logits, cache = model.prefill(p, lay(head), cache)
        out = [logits]
        if chunk:
            start = place(torch.full((B,), S - chunk, dtype=torch.int32,
                                     device=follow.device), ("batch",))
            logits, cache = model.prefill_chunk(
                p, lay({**batch, "tokens": batch["tokens"][:, S - chunk:]}),
                cache, start)
            out.append(logits)
        for t in range(follow.shape[1]):
            tok = place(follow[:, t:t + 1], ("batch", None))
            pos = place(torch.full((B,), S + t, dtype=torch.int32,
                                   device=tok.device), ("batch",))
            logits, cache = model.decode_step(p, tok, cache, pos)
            out.append(logits)
        return out

    with torch.no_grad():
        ref = run(params, model.init_cache(B, max_len, enc_len,
                                           dtype=torch.float32),
                  lambda t, ax: t)
    calls = {"flash": 0, "scan": 0}
    plain = []
    wrapped = {"flash": kops.flash_attention, "scan": kops.linear_scan}

    def counting(name):
        def call(*a, **kw):
            calls[name] += 1
            plain.append(not any(is_dtensor(t) for t in a))
            return wrapped[name](*a, **kw)
        return call

    with use_mesh_info(info), no_strided_views(), torch.no_grad():
        kops.flash_attention = counting("flash")
        kops.linear_scan = counting("scan")
        fa.launches = ls.launches = 0
        try:
            dp = distribute_tree(params, model.param_axes, info)
            specs = model.cache_specs(B, max_len, enc_len, dtype=torch.float32)
            cache = tree_map(lambda sp, t: info.distribute(t, sp.axes), specs,
                             model.init_cache(B, max_len, enc_len,
                                              dtype=torch.float32))
            got = [t.full_tensor() for t in run(dp, cache, info.distribute)]
        finally:
            kops.flash_attention = wrapped["flash"]
            kops.linear_scan = wrapped["scan"]
    return {"logits": np.stack([torch.stack(ref).cpu().numpy(),
                                torch.stack(got).cpu().numpy()]),
            "calls": np.array([calls["flash"], calls["scan"]]),
            "launches": np.array([fa.launches, ls.launches]),
            "local": np.array(all(plain))}
