"""Nested-dict trees: the port's stand-in for JAX pytrees.

Parameters and caches are plain nested ``dict``s whose leaves are tensors
(or ``Spec``s while a cache is being described), keyed exactly as the JAX
package keys its pytrees so the two can be compared leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

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


def sync(device: torch.device) -> None:
    """Wait for queued device work (host clocks around device work)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
