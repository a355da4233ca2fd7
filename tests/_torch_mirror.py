"""Run a reference orchestration test file against the port.

``load(name)`` reads ``tests/<name>.py``, rewrites its imports of the JAX
package's orchestration modules to the port's twins (``PORT_MODULES``),
checks that the rewritten source imports no ``repro`` or ``jax`` module,
and executes it.  Each ``tests/test_torch_core_<name>.py`` puts the
namespace in its globals, so pytest collects every reference test, with
the reference file's own helpers and fixtures, against the port.

The port's Common Crawl entry points do their tensor work on the card by
default; the mirror binds every function of ``CPU_BOUND`` that takes a
``device`` to ``device="cpu"``.  A reference test that needs a module the
port does not have yet is named in ``SKIP`` with the reason, and runs as a
skip.
"""
from __future__ import annotations

import ast
import builtins
import functools
import inspect
import types
from pathlib import Path

import pytest
from _pytest.assertion.rewrite import rewrite_asserts

TESTS = Path(__file__).resolve().parent

#: reference module -> the port's twin (a prefix match, longest first)
PORT_MODULES = {
    "repro.core": "repro_torch.core",
    "repro.launch.router": "repro_torch.launch.router",
    "repro.data": "repro_torch.data",
    "benchmarks.cc_pipeline": "benchmarks.torch_cc_pipeline",
    "repro.launch.dryrun": "repro_torch.launch.dryrun",
    "benchmarks.table1_cost": "benchmarks.torch_table1_cost",
    "benchmarks.fig3_reliability": "benchmarks.torch_fig3_reliability",
    "benchmarks.fig4_effort": "benchmarks.torch_fig4_effort",
    "benchmarks.fig5_cost_by_asset": "benchmarks.torch_fig5_cost_by_asset",
    "benchmarks.fig6_durations": "benchmarks.torch_fig6_durations",
}
#: the port's modules whose entry points take ``device`` (default "cuda")
CPU_BOUND = ("repro_torch.data.commoncrawl", "benchmarks.torch_cc_pipeline",
             "benchmarks.torch_table1_cost", "benchmarks.torch_fig3_reliability",
             "benchmarks.torch_fig4_effort",
             "benchmarks.torch_fig5_cost_by_asset",
             "benchmarks.torch_fig6_durations")
#: the reference files mirrored by tests/test_torch_core_<name>.py
MIRRORED = ("test_orchestrator", "test_planner", "test_store",
            "test_recovery", "test_adaptive", "test_selection",
            "test_schedule_engine", "test_router", "test_commoncrawl",
            "test_planner_properties", "test_properties", "test_paper_claims")
#: (reference file, test) -> why the port cannot run it yet
SKIP: dict[tuple[str, str], str] = {}


def _port_name(module: str) -> str:
    for ref in sorted(PORT_MODULES, key=len, reverse=True):
        if module == ref or module.startswith(ref + "."):
            return PORT_MODULES[ref] + module[len(ref):]
    return module


def _banned(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro")


@functools.cache
def _cpu_view(module: types.ModuleType) -> types.ModuleType:
    view = types.ModuleType(module.__name__, module.__doc__)
    for key, value in vars(module).items():
        if inspect.isfunction(value) and \
                "device" in inspect.signature(value).parameters:
            value = functools.partial(value, device="cpu")
        setattr(view, key, value)
    return view


def _import(name, globals=None, locals=None, fromlist=(), level=0):
    """``__import__`` that hands out the CPU views of ``CPU_BOUND``."""
    module = builtins.__import__(name, globals, locals, fromlist, level)
    if level or not fromlist:
        return module
    if name in CPU_BOUND:
        return _cpu_view(module)
    swapped = {f: _cpu_view(getattr(module, f)) for f in fromlist
               if f"{name}.{f}" in CPU_BOUND}
    if not swapped:
        return module
    return types.SimpleNamespace(**{
        **{f: getattr(module, f) for f in fromlist if f != "*"}, **swapped})


def _skipped(name: str, reason: str):
    def test():
        pytest.skip(reason)

    test.__name__ = test.__qualname__ = name
    return test


def reference_tests(tree: ast.Module) -> list[str]:
    """The module-level test functions of a parsed test file."""
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name.startswith("test")]


def load(name: str) -> dict:
    path = TESTS / f"{name}.py"
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    skips = {test: why for (ref, test), why in SKIP.items() if ref == name}
    tree.body = [n for n in tree.body if getattr(n, "name", None) not in skips]
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            node.module = _port_name(node.module)
            found = [node.module]
        elif isinstance(node, ast.Import):
            for alias in node.names:
                alias.name = _port_name(alias.name)
            found = [alias.name for alias in node.names]
        else:
            continue
        bad = [m for m in found if _banned(m)]
        if bad:
            raise ImportError(f"{path.name}:{node.lineno} still imports {bad} "
                              "after the rewrite to the port")
    rewrite_asserts(tree, source.encode(), str(path))
    ns = {"__name__": f"test_torch_core_{name.removeprefix('test_')}",
          "__file__": str(path),
          "__builtins__": {**vars(builtins), "__import__": _import}}
    exec(compile(tree, str(path), "exec"), ns)
    for test, why in skips.items():
        ns[test] = _skipped(test, why)
    return {k: v for k, v in ns.items() if not k.startswith("__")}
