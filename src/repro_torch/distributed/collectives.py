"""Collectives over a mesh axis's process group (port of
``repro.distributed.collectives``, plus the differentiable forms of the
collectives the local-map bodies use).

int8 gradient compression with error feedback, for the slow cross-pod hop:
the 2x16x16 production mesh reduces gradients over the 'pod' axis across
data-center-interconnect-class links, and int8 quantization cuts that
traffic 4x vs f32.  Error feedback (residual carrying, Seide et al. / 1-bit
SGD lineage) keeps SGD convergence unbiased.  Usage: where the gradients of
each pod are averaged, replace the all-reduce with
``compressed_psum(g, mesh.get_group("pod"), error)``.

Autograd: ``all_gather_tiled``, ``all_to_all_tiled`` and ``pmean`` carry
gradients, read as in a ``local_map`` body: each rank's gradient of a
rank-local value is its own contribution, and a replicated result's
gradient reaches every rank whole.  So the transpose of an all-gather sums
the ranks' contributions to each shard, an all-to-all sends gradients back
the way the values came, and a mean over the ranks scales the gradient by
1 / n without communicating.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.utils import tree_leaves, tree_map, tree_unflatten


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: returns (q, scale)."""
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, group: Any,
                    error: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized mean-reduce over ``group`` with error feedback.

    Returns (mean_estimate, new_error).  Communicates the int8 payload (an
    all-reduce over int32 accumulators to avoid overflow: 127 * group size
    << 2^31) plus one f32 scale per tensor (max-reduced, so the integer sum
    is meaningful).  ``torch.round`` rounds half to even, as ``jnp.round``.
    """
    x32 = x.to(torch.float32)
    if error is not None:
        x32 = x32 + error
    q, total, scale = quantized_sum(x32, group)
    n = dist.get_world_size(group)
    mean = total.to(torch.float32) * scale / n
    new_error = x32 - q.to(torch.float32) * scale  # local residual
    return mean.to(x.dtype), new_error


def quantized_sum(x32: torch.Tensor, group: Any
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(this rank's int32 quanta, their sum over ``group``, the shared
    scale) of the f32 ``x32``."""
    amax = x32.abs().max().reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = amax[0] / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int32)
    # the reduction's buffer must be dense: a gradient from a product on
    # local shards may be a transposed view, whose layout clone() keeps
    total = q.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return q, total, scale


def init_error_state(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compressed_psum_tree(grads: Any, group: Any, errors: Any
                         ) -> tuple[Any, Any]:
    out_g, out_e = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(errors)):
        m, ne = compressed_psum(g, group, e)
        out_g.append(m)
        out_e.append(ne)
    return tree_unflatten(grads, out_g), tree_unflatten(grads, out_e)


# ---------------------------------------------------------------------------
# differentiable collectives for local-map bodies
# ---------------------------------------------------------------------------


def _gather_cat(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _exchange(x: torch.Tensor, split_dim: int, concat_dim: int,
              group: Any) -> torch.Tensor:
    """Tiled all-to-all: block i of ``x`` along ``split_dim`` goes to rank
    i; the blocks received are concatenated along ``concat_dim`` in rank
    order (``lax.all_to_all(..., tiled=True)``)."""
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        # reduce-scatter: the sum over ranks of each rank's gradient, then
        # this rank's block
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[r], None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _exchange(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _exchange(g, concat_dim, split_dim, ctx.group), None, None, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        y = x.clone()
        n = 1
        for grp in groups:
            dist.all_reduce(y, group=grp)
            n *= dist.get_world_size(grp)
        ctx.n = n
        return y / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def all_gather_tiled(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    return _AllGather.apply(x, dim, group)


def all_to_all_tiled(x: torch.Tensor, split_dim: int, concat_dim: int,
                     group: Any) -> torch.Tensor:
    return _AllToAll.apply(x, split_dim, concat_dim, group)


def pmean(x: torch.Tensor, groups: tuple) -> torch.Tensor:
    """The mean of ``x`` over every rank of ``groups`` (one group per mesh
    dim, together the whole mesh)."""
    return _Mean.apply(x, groups)
