"""The port's training step under a mesh on four gloo ranks of the CPU, for a
machine without JAX (the cards' machine, whose torch differs from the
one the CPU tests run under).  Only ``--export-parity`` imports JAX.

    python tests/_torch_mesh_probe.py [ARCH ...] [--out FILE]
        every smoke arch (or those named) on the (data, model) meshes
        (2, 2), (1, 4) and (4, 1): tests/test_torch_gpu_mesh.py's MODEL body
        (port weights, ``sharded_vs_unsharded``), four ranks a case, two
        cases at a time; the loss on the mesh against the unsharded loss
        (rtol 2e-4) and every gradient against the unsharded one (1e-4 of
        its max |g|)
    python tests/_torch_mesh_probe.py --export-parity DIR   (needs JAX)
        tests/test_torch_distributed_train.py's parity cases -- JAX's
        weights, batches and single-device losses -- written to DIR
    python tests/_torch_mesh_probe.py --parity DIR [--out FILE]
        those cases' PARITY body on four gloo ranks, held to the tests'
        limits: the loss against the unsharded run and, where the tests
        hold it so, JAX's (rtol 2e-4), every gradient within 1e-4 of its
        max |g|

Exits non-zero if a case fails; each failure prints its ranks' log tail.
"""
from __future__ import annotations

import argparse
import ast
import concurrent.futures as cf
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

MESHES = [(2, 2), (1, 4), (4, 1)]
LOSS_RTOL, GRAD_TOL = 2e-4, 1e-4


def _model_cases() -> tuple[str, dict]:
    from test_torch_gpu_mesh import CASES, MODEL

    moe = ("granite_moe_1b_a400m", {"capacity_factor": 4.0}, 4, 32, 16, "loss")
    dense = {a: (a.replace("-", "_").replace(".", "_"), {}, 4, 32, 4096,
                 "total_loss")
             for a in ("gemma-2b", "deepseek-7b", "h2o-danube-1.8b",
                       "minicpm3-4b", "whisper-medium")}
    return MODEL, {**dense, "recurrentgemma-9b": CASES["rglru"],
                   "rwkv6-1.6b": CASES["rwkv"], "qwen2-vl-72b": CASES["gqa"],
                   "granite-moe-1b-a400m": moe,
                   "deepseek-v2-236b": CASES["moe"]}


def probe(names: list[str]) -> list[dict]:
    from _torch_dist import run_ranks

    body, cases = _model_cases()
    jobs = [(n, m) for n in (names or list(cases)) for m in MESHES]

    def one(name, mesh):
        d = tempfile.mkdtemp(prefix=f"{name}_{mesh[0]}x{mesh[1]}_")
        t0 = time.time()
        try:
            got = run_ranks(f"CASE = {cases[name]!r}\nMESH = {mesh!r}\n" + body,
                            4, d, timeout=300)["case"]
        except AssertionError as e:
            return dict(name=name, mesh=mesh, ok=False, err=str(e)[-2500:],
                        s=round(time.time() - t0, 1))
        finally:
            shutil.rmtree(d, ignore_errors=True)
        un, sh = (float(x) for x in got["loss"])
        rel, grad = abs(sh - un) / abs(un), float(got["grad_err"].max())
        return dict(name=name, mesh=mesh, ok=rel <= LOSS_RTOL and grad < GRAD_TOL,
                    loss=[un, sh], rel=rel, grad_err=grad,
                    s=round(time.time() - t0, 1))

    out = []
    with cf.ThreadPoolExecutor(2) as ex:
        for r in ex.map(lambda a: one(*a), jobs):
            out.append(r)
            what = (f"loss rel {r['rel']:.3e}, worst gradient {r['grad_err']:.3e}"
                    if "rel" in r else "stopped")
            print(f"[probe] {r['name']} {tuple(r['mesh'])}: "
                  f"{'ok' if r['ok'] else 'FAIL'}: {what} ({r['s']} s)",
                  flush=True)
    return out


def export_parity(d: Path) -> None:
    """Run the test's ``parity`` fixture with JAX, its ranks' run stubbed
    out: the cases land in ``d`` with JAX's losses."""
    import test_torch_distributed_train as t

    class Factory:
        def mktemp(self, name):
            shutil.rmtree(d, ignore_errors=True)
            d.mkdir(parents=True)
            return d

    t.run_ranks = lambda body, world, tmp_path, **kw: {
        n: {} for n in json.loads((d / "cases.json").read_text())}
    cases = t.parity.__wrapped__(Factory())
    (d / "jax_losses.json").write_text(
        json.dumps({k: v[1] for k, v in cases.items()}))
    print(f"[parity] {len(cases)} cases written to {d}")


def _parity_body() -> str:
    src = (ROOT / "tests" / "test_torch_distributed_train.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "PARITY":
            return ast.literal_eval(node.value)
    raise LookupError("no PARITY body in test_torch_distributed_train.py")


def parity(d: Path) -> list[dict]:
    from _torch_dist import run_ranks

    jax = json.loads((d / "jax_losses.json").read_text())
    got = run_ranks(_parity_body(), 4, d, timeout=900)
    out = []
    for name in sorted(got):
        un, sh = (float(x) for x in got[name]["loss"])
        grad = float(got[name]["grad_err"].max())
        rel, rel_jax = abs(sh - un) / abs(un), abs(sh - jax[name]) / abs(jax[name])
        # as the tests hold them: "moe" by its loss alone (its router loss
        # is per shard on the mesh); "moe_grad" (the next-token loss) and
        # "moe_router" (nothing dropped at E / top_k) not against JAX
        ok = rel <= LOSS_RTOL and (name in ("moe_grad", "moe_router")
                                   or rel_jax <= LOSS_RTOL) and (
            name == "moe" or grad < GRAD_TOL)
        out.append(dict(name=name, ok=ok, loss=[un, sh], jax=jax[name],
                        rel=rel, rel_jax=rel_jax, grad_err=grad))
        print(f"[parity] {name}: {'ok' if ok else 'FAIL'}: loss {sh!r} on the "
              f"mesh, {un!r} unsharded, {jax[name]!r} JAX (rel {rel:.3e}, "
              f"{rel_jax:.3e}); worst gradient {grad:.3e}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("archs", nargs="*")
    ap.add_argument("--export-parity", type=Path, default=None)
    ap.add_argument("--parity", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import torch

    print(f"[probe] torch {torch.__version__}", flush=True)
    if args.export_parity:
        export_parity(args.export_parity.resolve())
        return
    rows = parity(args.parity.resolve()) if args.parity else probe(args.archs)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    bad = [r for r in rows if not r["ok"]]
    for r in bad:
        print(f"===== {r['name']} {r.get('mesh', '')}\n{r.get('err', '')[-1800:]}")
    print(f"[probe] {len(rows) - len(bad)} of {len(rows)} passed")
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
