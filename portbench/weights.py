"""Weights from a seed, made on the device in one draw.

``make_weights`` fills every leaf of a parameter tree (paths and shapes as
the program declares them) from one ``torch.randn`` call on a generator
seeded with the run's seed, then shapes each leaf by the rule that the
configuration file gives its name (``init``): a normal of a given mean and
standard deviation, a fan-in scaled normal, or a uniform interval (the
normal's draw through its own distribution function).  The same seed gives
the same numbers on both sides of a comparison, so the program and the
plain reference read the same weights without sharing a tensor.
"""
from __future__ import annotations

import math

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rule(init: dict, path: str) -> dict:
    name = path.rsplit("/", 1)[-1]
    parent = path.rsplit("/", 2)[-2] if path.count("/") >= 1 else ""
    for key in (f"{parent}/{name}", name):
        if key in init:
            return init[key]
    raise KeyError(f"no init rule for weight {path!r} (tried "
                   f"{parent}/{name!r} and {name!r})")


def _shape_leaf(z: torch.Tensor, rule: dict, layered: bool) -> torch.Tensor:
    """Shape one standard-normal draw ``z`` in place by ``rule``."""
    if "uniform" in rule:
        lo, hi = rule["uniform"]
        return torch.special.ndtr(z, out=z).mul_(hi - lo).add_(lo)
    if "fan_in" in rule:
        dims = z.shape[1:] if layered else z.shape
        std = 1.0 / math.sqrt(math.prod(dims[i] for i in rule["fan_in"]))
    else:
        std = rule["std"]
    return z.mul_(std).add_(rule.get("mean", 0.0))


def make_weights(shapes: dict[str, tuple[int, ...]], init: dict, seed: int,
                 device, dtype: str = "float32",
                 matrix_dtype: str | None = None,
                 layered: frozenset[str] = frozenset()) -> dict:
    """``{path: tensor}`` for every ``(path, shape)`` of ``shapes``.  Leaves
    whose path starts with a prefix in ``layered`` carry a leading layers
    axis, which a fan-in rule skips.  A leaf of rank two or more per layer
    is made in ``matrix_dtype`` (default ``dtype``), the others in
    ``dtype``."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out = {}
    at = 0
    for path in sorted(shapes):
        shape = shapes[path]
        n = math.prod(shape)
        lay = any(path.startswith(p) for p in layered)
        z = _shape_leaf(flat[at:at + n].view(shape), _rule(init, path), lay)
        at += n
        rank = len(shape) - int(lay)
        dt = _DTYPES[matrix_dtype or dtype] if rank >= 2 else _DTYPES[dtype]
        out[path] = z.clone() if dt == torch.float32 else z.to(dt)
    del flat
    return out


def nest(flat: dict) -> dict:
    """``{"a/b": t}`` -> ``{"a": {"b": t}}``: the program's tree."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree
