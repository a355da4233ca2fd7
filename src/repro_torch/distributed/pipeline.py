"""Optional GPipe-style pipeline parallelism over a mesh axis (port of
``repro.distributed.pipeline``).

The production mesh uses DP x TP (+pod DP), so PP is off by default; this
module exists because 1000+-node deployments of deep models want the
option.  Implementation: one stage per rank of the mesh axis, a static
schedule of T = n_micro + n_stages - 1 ticks, and each tick a cyclic shift
of activations stage -> stage+1 with ``batch_isend_irecv`` (a local copy
with one stage).  Differentiable: the shift's backward sends gradients the
other way, and every rank runs the same graph, so the point-to-point
messages of the backward pair up as those of the forward do.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.utils import tree_map


def _shift(x: torch.Tensor, group: Any, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` places on in ``group`` (cyclically)
    and return what the rank ``step`` places back sent."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    r = dist.get_rank(group)
    to = dist.get_global_rank(group, (r + step) % n)
    frm = dist.get_global_rank(group, (r - step) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to, group),
                                       dist.P2POp(dist.irecv, out, frm, group)]):
        req.wait()
    return out


class _Shift(torch.autograd.Function):
    """``lax.ppermute`` with the perm i -> i+1: its transpose is i+1 -> i."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _FromLast(torch.autograd.Function):
    """The last rank's ``x`` on every rank.  The result is replicated, so
    its gradient reaches every rank whole: the last rank keeps it, the
    others pass none back."""

    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.last = dist.get_rank(group) == n - 1
        out = x.clone().contiguous()
        if n > 1:
            dist.broadcast(out, dist.get_global_rank(group, n - 1), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,  # leaves stacked over n_stages on dim 0
    x: torch.Tensor,  # (n_micro, micro_batch, ...), the same on every rank
    mesh: Any,
    axis: str = "model",
) -> torch.Tensor:
    """Runs x through n_stages sequential stages, pipelined over microbatches.

    ``stage_fn(params_for_one_stage, h) -> h``, same shape (the classic GPipe
    restriction).  Every rank of ``mesh`` calls this; the rank at position
    s along ``axis`` runs stage s.  Returns (n_micro, micro_batch, ...)
    outputs, the same on every rank."""
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    n_micro = x.shape[0]
    params = tree_map(lambda a: a[stage], stage_params)
    first = 1.0 if stage == 0 else 0.0
    last = 1.0 if stage == n_stages - 1 else 0.0

    buf = torch.zeros_like(x[0])  # current activation on this stage
    outs: list[torch.Tensor] = []
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests microbatch t (zeros once they run out); the others
        # read what the previous stage sent.  Both terms stay in the graph
        # on every rank, so every rank's backward runs every shift.
        feed = x[t] if t < n_micro else torch.zeros_like(x[0])
        h_out = stage_fn(params, first * feed + (1.0 - first) * buf)
        if t >= n_stages - 1:  # the last stage emits microbatch t - S + 1
            outs.append(last * h_out)
        if t < n_micro + n_stages - 2:
            buf = _Shift.apply(h_out, group)
    return _FromLast.apply(torch.stack(outs), group)
