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
run on a mesh against the unsharded run.
"""
from __future__ import annotations

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


def sharded_vs_unsharded(model, params, batch, info, which="total_loss",
                         reference=None) -> dict:
    """The loss ``which`` (a key of ``train_loss``'s metrics) and its
    gradients from ``params`` and ``batch``, unsharded and then on ``info``'s
    mesh (parameters laid out by ``param_axes``, the batch as ``("batch",
    "seq_act")``).  ``reference(params, batch)``, where given, is the
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
    with use_mesh_info(info):
        moe.PATH_CALLS.update(dense=0, shard_map=0)
        dp = distribute_tree(tree_map(lambda t: t.detach(), params),
                             model.param_axes, info)
        dl = [p.requires_grad_(True) for p in tree_leaves(dp)]
        db = {k: info.distribute(v, ("batch", "seq_act"))
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
