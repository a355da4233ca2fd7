"""Nested-dict trees: the port's stand-in for JAX pytrees.

Parameters and caches are plain nested ``dict``s whose leaves are tensors
(or ``Spec``s while a cache is being described), keyed exactly as the JAX
package keys its pytrees so the two can be compared leaf by leaf.  The
size, formatting and timing helpers at the end are ``repro.utils``'s.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Iterator, NamedTuple

import numpy as np
import torch


class Spec(NamedTuple):
    """Shape, dtype and logical axes of one cache leaf (the port's
    ``(jax.ShapeDtypeStruct, axes)`` pair).  ``axes`` names each dim;
    ``"batch"`` and ``"pages"`` tell gather/scatter code where slots and
    pool pages live."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    axes: tuple[str | None, ...]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over one or more dict trees of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in JAX's flattening order (dict keys sorted),
    the path ``/``-joined as ``repro.checkpoint`` keys its arrays."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_flatten(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def tree_leaves(tree: Any) -> list[Any]:
    """The leaves of ``tree`` in JAX's flattening order."""
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_unflatten(like: Any, leaves: list[Any]) -> Any:
    """Inverse of ``tree_leaves``: the dict structure of ``like`` holding
    ``leaves`` in JAX's flattening order."""
    it = iter(leaves)

    def build(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def take_fill(x: torch.Tensor, idx: torch.Tensor, dim: int, fill,
              bound: int | None = None) -> torch.Tensor:
    """``jnp.take(x, idx, axis=dim, mode="fill", fill_value=fill)``: indices
    outside ``[0, bound)`` (default ``x.shape[dim]``) read ``fill``.  Clamp,
    gather, then mask -- no data-dependent shapes, so no host sync."""
    n = x.shape[dim] if bound is None else bound
    idx = idx.long()
    valid = (idx >= 0) & (idx < n)
    out = x.index_select(dim, idx.clamp(0, n - 1))
    shape = [1] * x.ndim
    shape[dim] = idx.numel()
    return torch.where(valid.view(shape), out, fill)


def to_device(data, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host data (a list or numpy array) as a tensor on ``device`` without
    waiting for the device: on a card, through pinned memory and a
    non-blocking copy (the caching host allocator keeps the pinned block
    until the copy has run), where a pageable copy would synchronise the
    stream first."""
    t = torch.as_tensor(data, dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def sync(device: torch.device) -> None:
    """Wait for queued device work (host clocks around device work)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Sizes, formatting and timing (the port's copy of ``repro.utils``)
# ---------------------------------------------------------------------------


def _shaped_leaves(tree: Any) -> list[Any]:
    """Every leaf with a ``shape`` under dicts, lists and tuples."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _shaped_leaves(v)]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return [x for v in tree for x in _shaped_leaves(v)]
    return [tree] if hasattr(tree, "shape") else []


def tree_size(tree: Any) -> int:
    """Total number of elements across all leaves (a DTensor counts whole)."""
    return sum(math.prod(x.shape) for x in _shaped_leaves(tree))


def tree_bytes(tree: Any) -> int:
    """Total bytes across all leaves: tensors on any device, meta and fake
    tensors included (shape times itemsize, nothing read), ``Spec``s and
    numpy arrays too."""
    total = 0
    for x in _shaped_leaves(tree):
        dt = x.dtype
        size = dt.itemsize if isinstance(dt, torch.dtype) else np.dtype(dt).itemsize
        total += math.prod(x.shape) * size
    return total


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB", "PiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} EiB"


def human_count(n: float) -> str:
    for unit in ("", "K", "M", "B", "T"):
        if abs(n) < 1000.0:
            return f"{n:.2f}{unit}"
        n /= 1000.0
    return f"{n:.2f}Q"


def human_time(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{seconds * 1e6:.1f} us"
    if seconds < 1.0:
        return f"{seconds * 1e3:.2f} ms"
    if seconds < 120.0:
        return f"{seconds:.2f} s"
    return f"{seconds / 60.0:.1f} min"


class Stopwatch:
    def __enter__(self) -> "Stopwatch":
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.elapsed = time.perf_counter() - self.start


def round_up(x: int, multiple: int) -> int:
    return int(math.ceil(x / multiple) * multiple)


def chunks(seq: list, n: int) -> Iterator[list]:
    for i in range(0, len(seq), n):
        yield seq[i: i + n]
