"""Each mirrored reference file is collected whole against the port: the
mirror holds every test function its reference has (a test the port cannot
run yet is there as a skip, named in ``_torch_mirror.SKIP``), and every name
it binds from the packages comes from the port."""
import ast
import importlib
import inspect

import pytest

from _torch_mirror import MIRRORED, SKIP, TESTS, reference_tests


def _origin(value) -> str:
    if inspect.ismodule(value):
        return value.__name__
    return getattr(getattr(value, "func", value), "__module__", "") or ""


@pytest.mark.parametrize("ref", MIRRORED)
def test_mirror_collects_every_reference_test(ref):
    want = reference_tests(ast.parse((TESTS / f"{ref}.py").read_text()))
    mirror = importlib.import_module(
        f"test_torch_core_{ref.removeprefix('test_')}")
    got = [k for k, v in vars(mirror).items()
           if k.startswith("test") and callable(v)]
    assert sorted(got) == sorted(want)
    assert all(test in want for r, test in SKIP if r == ref)
    origins = {k: _origin(v) for k, v in vars(mirror).items()}
    assert not [k for k, o in origins.items()
                if o.split(".")[0] in ("repro", "jax", "jaxlib")], origins
    assert any(o.startswith(("repro_torch.", "benchmarks.torch_"))
               for o in origins.values())
