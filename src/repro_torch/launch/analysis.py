"""Dry-run analysis: the roofline of one step, the bytes each rank holds, and
the collectives each rank issues (the port's counterpart of
``repro.launch.analysis``).

The reference reads XLA's compiled artifact: ``memory_analysis``,
``cost_analysis`` and the collectives parsed from the post-SPMD HLO text.
Torch has no compiled artifact to read.  Here the step runs once on fake
tensors over a fake process group (``launch/dryrun.py``):

* ``argument_bytes`` sums each leaf's local shard: exactly what a rank
  holds of the parameters, optimizer state, batch and cache (the
  reference's ``memory_analysis.argument_size_in_bytes``);
* ``CollectiveCounter`` counts the collectives DTensor and the port's own
  collectives issue in that run, per rank, with the reference's byte proxy
  (each op's result bytes).  Every layer runs, so no loop trip count has
  to be recovered, as the reference's HLO parse must; and the bytes are
  those of the tensors' own dtypes, so the reference's bf16 correction of
  CPU-lowered f32 collectives does not apply;
* ``roofline`` is the reference's formula over ``H100_SXM``'s datasheet
  rates (989 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s NVLink a direction).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.platforms import H100_SXM

PEAK_FLOPS = H100_SXM.peak_flops
HBM_BW = H100_SXM.hbm_bw
LINK_BW = H100_SXM.link_bw

#: the reference's collective kinds, and the op-name stems that map to each
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = (("all_gather", "all-gather"), ("allgather", "all-gather"),
         ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
         ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
         ("alltoall", "all-to-all"), ("broadcast", "collective-permute"),
         ("send", "collective-permute"), ("recv", "collective-permute"),
         ("permute", "collective-permute"))


def _tensors(x: Any) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


def _nbytes(ts: list[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _kind(op) -> str | None:
    ns, name = op.namespace, op._opname
    if ns not in ("_c10d_functional", "c10d", "c10d_functional", "_dtensor"):
        return None
    for stem, kind in _KIND:
        if stem in name:
            return kind
    return None


class CollectiveCounter(TorchDispatchMode):
    """Bytes and counts of the collectives one rank issues while active,
    keyed by the reference's kinds.  The byte proxy is the op's result: a
    functional collective's returned tensor, an in-place c10d collective's
    output argument (its first).  Waits are not counted."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        # a mode runs before a tensor subclass: let DTensor desugar its op
        # into local ops and collectives first, then see those (as
        # CommDebugMode does)
        if not isinstance(func, torch._ops.HigherOrderOperator) and any(
                issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        kind = _kind(func)
        if kind is not None:
            moved = _tensors(out) if func.namespace != "c10d" else \
                _tensors(args[0] if args else [])
            self.bytes[kind] += _nbytes(moved)
            self.counts[kind] += 1
        return out

    def summary(self) -> dict[str, float]:
        """One key per kind and ``total``, in bytes per rank."""
        out = {k: float(self.bytes.get(k, 0.0)) for k in COLLECTIVES}
        out["total"] = sum(out.values())
        return out

    def op_counts(self) -> dict[str, int]:
        return {k: int(self.counts.get(k, 0)) for k in COLLECTIVES}


def argument_bytes(*trees: Any) -> int:
    """Per-rank residency of the step's arguments: the sum over every
    tensor leaf (dicts, lists, tuples) of what this rank holds of it -- a
    DTensor's local shard, a plain tensor whole (fake and meta tensors
    count by shape)."""
    def leaves(t: Any):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                yield from leaves(v)
        elif isinstance(t, torch.Tensor):
            yield t

    local = [x.to_local() if hasattr(x, "to_local") else x
             for t in trees for x in leaves(t)]
    return sum(x.numel() * x.element_size() for x in local)


def roofline(flops_per_device: float, hbm_bytes_per_device: float,
             coll_bytes_per_device: float, model_flops_total: float,
             n_chips: int) -> dict[str, float]:
    """The reference's roofline (``repro/launch/analysis.py:270``) at
    ``H100_SXM``'s rates: each term is the step's work over the card's peak
    rate for it, and the step takes the largest."""
    t_comp = flops_per_device / PEAK_FLOPS
    t_mem = hbm_bytes_per_device / HBM_BW
    t_coll = coll_bytes_per_device / LINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)  # type: ignore[arg-type]
    step_time = max(terms.values())
    useful = model_flops_total / max(1.0, flops_per_device * n_chips)
    mfu = (model_flops_total / n_chips / PEAK_FLOPS) / max(step_time, 1e-12)
    return {
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "bottleneck": bottleneck,  # type: ignore[dict-item]
        "step_time_s": step_time,
        "useful_flops_ratio": useful,
        "model_flops_util": mfu,
    }
