"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP) over a
``torch.distributed`` ``DeviceMesh`` (port of ``repro.distributed.sharding``).

Every tensor dim in the model is annotated with a *logical* axis name; this
module maps logical names -> mesh axes, with automatic fallback when a dim is
not divisible by the mesh axis size (e.g. kv_heads=8 on a 16-way model axis).

JAX's ``PartitionSpec`` becomes a tuple with the same entries (``spec``), and
its ``NamedSharding`` becomes DTensor placements over the mesh
(``placements``, ``distribute``).  ``with_sharding_constraint`` becomes
``DTensor.redistribute`` (``constrain``).  The mapping is carried in a
thread-local context (``MeshInfo``) so the same model code runs on plain
tensors without a mesh and on DTensors under one.

Under a mesh every tensor the model touches is a DTensor: a tensor built
inside the model from nothing (an ``arange`` of positions, a table of
frequencies) is made a replicated DTensor with ``replicate``, and
``constrain`` raises for a plain tensor, so a tensor that escaped the mesh
shows up instead of passing silently.

The model's products go through ``einsum`` and ``matmul``: without a
DTensor operand they are ``torch.einsum`` and ``@``; under a mesh they run
on each rank's local shards, so DTensor never has to fold a split dim.
Norms go through ``rowwise`` the same way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, Mapping, Sequence

import torch

# Logical axis -> preferred mesh axes (in order; each mesh axis used at most
# once per tensor).  "batch" spreads over the pure-DP axes (pod + data);
# "*_fsdp" are ZeRO-3 weight shards over the data axis; "heads"/"mlp"/"vocab"/
# "experts" are tensor/expert parallel over the model axis; "seq_act" is
# Megatron-style sequence parallelism for the residual stream; "kv_seq" shards
# long KV caches / decode-time sequence over the model axis (SP-decode).
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "batch_data_only": ("data",),
    "seq_act": ("model",),
    "kv_seq": ("model",),
    "embed_fsdp": ("data",),
    "ff_fsdp": ("data",),
    "vocab_fsdp": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_ff_fsdp": ("data",),
    "lru_width": ("model",),
    "rwkv_heads": ("model",),
    "layers": (),
    "head_dim": (),
    "qk_dim": (),
    "v_dim": (),
    "lora": (),
    "window": (),
    "conv": (),
    "state": (),
    "stats": (),
    None: (),
}


def _is_axes(a: Any) -> bool:
    """A leaf of an axes tree: a tuple of logical names (or None)."""
    return isinstance(a, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in a)


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """A mesh plus the logical->physical rules active for this run.  ``mesh``
    is a ``DeviceMesh`` (named dims), or anything with ``axis_names`` and a
    ``devices`` array, which is enough for the spec logic."""

    mesh: Any
    rules: Mapping[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES)
    )

    @property
    def axis_names(self) -> tuple[str, ...]:
        names = getattr(self.mesh, "axis_names", None)
        return tuple(names if names is not None else self.mesh.mesh_dim_names)

    @property
    def axis_sizes(self) -> dict[str, int]:
        devices = getattr(self.mesh, "devices", None)
        shape = devices.shape if devices is not None else tuple(self.mesh.shape)
        return dict(zip(self.axis_names, shape))

    def axis_size(self, name: str) -> int:
        return self.axis_sizes.get(name, 1)

    def mesh_axes_for(self, logical: str | None, dim_size: int) -> tuple[str, ...]:
        """Resolve a logical axis to mesh axes, dropping axes that don't divide
        ``dim_size`` or don't exist in this mesh (divisibility fallback)."""
        axes: list[str] = []
        prod = 1
        for ax in self.rules.get(logical, ()):  # type: ignore[arg-type]
            size = self.axis_sizes.get(ax)
            if size is None or size <= 1:
                continue
            if dim_size % (prod * size) != 0:
                continue
            axes.append(ax)
            prod *= size
        return tuple(axes)

    def spec(self, shape: Sequence[int], axes: Sequence[str | None]) -> tuple:
        """The entries of JAX's PartitionSpec for a tensor with the given
        shape + logical axes: per dim None, one mesh axis, or a tuple of
        them; trailing Nones trimmed.  A mesh axis is only used once per
        tensor (first dim wins)."""
        assert len(shape) == len(axes), (shape, axes)
        used: set[str] = set()
        entries: list[Any] = []
        for dim, logical in zip(shape, axes):
            resolved = [a for a in self.mesh_axes_for(logical, dim) if a not in used]
            # re-check divisibility after dropping already-used axes
            prod = 1
            keep: list[str] = []
            for a in resolved:
                size = self.axis_sizes[a]
                if dim % (prod * size) == 0:
                    keep.append(a)
                    prod *= size
            used.update(keep)
            if not keep:
                entries.append(None)
            elif len(keep) == 1:
                entries.append(keep[0])
            else:
                entries.append(tuple(keep))
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def placements(self, spec: tuple) -> list:
        """One DTensor placement per mesh dim: ``Shard(d)`` where tensor dim
        ``d``'s spec entry names that mesh axis, else ``Replicate()``.  A dim
        over two mesh axes (``("pod", "data")``) is ``Shard(d)`` on both,
        the outer mesh dim taking the outer blocks, as in JAX."""
        from torch.distributed.tensor import Replicate, Shard

        where: dict[str, int] = {}
        for d, entry in enumerate(spec):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    where[ax] = d
        return [Shard(where[ax]) if ax in where else Replicate()
                for ax in self.axis_names]

    def sharding(self, shape: Sequence[int], axes: Sequence[str | None]) -> list:
        """The placements of a tensor with these logical axes (JAX's
        ``NamedSharding`` on this mesh)."""
        return self.placements(self.spec(shape, axes))

    def distribute(self, x: torch.Tensor, axes: Sequence[str | None]):
        """``x`` (the same full tensor on every rank) as a DTensor laid out
        per its logical axes: each rank keeps its own shard."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(x, self.mesh, self.sharding(x.shape, axes))


class _MeshState(threading.local):
    def __init__(self) -> None:
        self.info: MeshInfo | None = None


_STATE = _MeshState()


def set_mesh_info(info: MeshInfo | None) -> None:
    _STATE.info = info


def current_mesh_info() -> MeshInfo | None:
    return _STATE.info


@contextlib.contextmanager
def use_mesh_info(info: MeshInfo | None):
    prev = _STATE.info
    _STATE.info = info
    try:
        yield info
    finally:
        _STATE.info = prev


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Redistribute ``x`` to the placements of its logical axes.

    No-op when no mesh is active (single-device runs) — the same model code
    is thereby portable between one card and a mesh.  Under a mesh ``x``
    must be a DTensor: a plain tensor raises ``TypeError``.
    """
    info = _STATE.info
    if info is None:
        return x
    if not is_dtensor(x):
        raise TypeError(f"constrain{axes}: a plain {tuple(x.shape)} tensor "
                        "under a mesh (every tensor of the model must be a "
                        "DTensor there)")
    return x.redistribute(info.mesh, info.sharding(x.shape, axes))


def replicate(x: torch.Tensor) -> torch.Tensor:
    """``x``, built the same on every rank, as a replicated DTensor when a
    mesh is active (a plain tensor and a DTensor do not mix); else ``x``."""
    info = _STATE.info
    if info is None or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, info.mesh, [Replicate()] * len(info.axis_names),
                              run_check=False)


def shard_map(fn, in_specs: tuple, out_specs):
    """JAX's ``shard_map`` through DTensor's ``local_map``: ``fn`` runs on
    each rank's local shards.  ``in_specs`` holds one spec (a PartitionSpec
    tuple of mesh axis names, as ``MeshInfo.spec`` gives) per argument, or
    None for an argument that is not a DTensor; inputs are redistributed to
    their specs.  ``out_specs`` is one spec, or a list of specs for a tuple
    of outputs.

    Gradients: ``fn``'s local gradient of an input replicated over a mesh
    dim that an output is sharded over is a partial sum over that dim (each
    rank saw only its own rows), and is declared ``Partial``; every other
    local gradient has its input's placement.  A collective inside ``fn``
    must be differentiable under the same reading: a replicated output's
    gradient reaches every rank whole."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    info = _STATE.info
    many = isinstance(out_specs, list)
    outs = out_specs if many else [out_specs]
    out_pl = [info.placements(s) for s in outs]
    varying = [any(not isinstance(pl[i], Replicate) for pl in out_pl)
               for i in range(len(info.axis_names))]
    in_pl = tuple(None if s is None else info.placements(s) for s in in_specs)
    grad_pl = tuple(None if pl is None else
                    [Partial() if isinstance(p, Replicate) and varying[i] else p
                     for i, p in enumerate(pl)] for pl in in_pl)
    return local_map(fn, out_placements=tuple(out_pl) if many else out_pl[0],
                     in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=info.mesh, redistribute_inputs=True)


def _product_placements(ins: list[str], out: str, ops: list, mesh) -> tuple:
    """Per mesh dim, the output letter each operand is split on for a local
    product, or none: (in placements per operand, out placements).

    A candidate is an output letter that some operand is already split on
    along that mesh dim (and that the cumulative split still divides); the
    one kept is the cheapest to reach: an operand split on another letter
    is gathered (its whole size) or, when it holds the letter, swapped
    all-to-all (its size over the split).  Ties keep the first operand's.
    A contracted letter is never kept, so no output is a partial sum."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = {c: n for spec, o in zip(ins, ops) for c, n in zip(spec, o.shape)}
    numel = [math.prod(o.shape) for o in ops]
    split = dict.fromkeys(sizes, 1)
    chosen: list[str | None] = []
    for i in range(mesh.ndim):
        n = mesh.size(i)
        have = [spec[p.dim] if isinstance(p, Shard) else None
                for spec, p in ((s, o.placements[i]) for s, o in zip(ins, ops))]
        cands = [c for c in dict.fromkeys(have) if c is not None and c in out
                 and n > 1 and sizes[c] % (split[c] * n) == 0]

        def cost(c):
            return sum(0 if h in (None, c) else
                       (numel[k] / n if c in ins[k] else numel[k])
                       for k, h in enumerate(have))

        pick = min(cands, key=cost) if cands else None
        if pick is not None:
            split[pick] *= n
        chosen.append(pick)
    in_pl = [[Shard(spec.index(c)) if c is not None and c in spec
              else Replicate() for c in chosen] for spec in ins]
    out_pl = [Shard(out.index(c)) if c is not None else Replicate()
              for c in chosen]
    return in_pl, out_pl


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(equation, *operands)``; when an operand is a DTensor,
    the same product on each rank's local shards.

    DTensor's own einsum and ``@`` fold the batch dims of an operand into
    one (``view``), and torch 2.11's DTensor cannot flatten a split dim
    that is not the first of the fold (a (batch, seq) split over (data,
    model)).  Here no DTensor is viewed: each mesh dim keeps one output
    letter split (``_product_placements``), the operands are laid out to
    match (a gather, an all-to-all, or a local slice of a replicated
    operand), and the einsum runs on plain local tensors inside
    ``local_map``.  A plain operand among DTensors is taken as replicated.
    The local gradient of an operand replicated over a mesh dim the output
    is split on is a partial sum there, and is declared ``Partial``."""
    if not any(is_dtensor(o) for o in operands):
        return torch.einsum(equation, *operands)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    ref = next(o for o in operands if is_dtensor(o))
    ops = [replicate_like(o, ref) for o in operands]
    lhs, out = equation.replace(" ", "").split("->")
    ins = lhs.split(",")
    mesh = ref.device_mesh
    in_pl, out_pl = _product_placements(ins, out, ops, mesh)
    grad_pl = [[Partial() if isinstance(p, Replicate)
                and not isinstance(out_pl[i], Replicate) else p
                for i, p in enumerate(pl)] for pl in in_pl]
    return local_map(functools.partial(torch.einsum, equation),
                     out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*ops)


def embedding(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(idx, table)``; when ``table`` is a DTensor, a
    vocab-parallel lookup on local shards: each rank keeps its block of
    rows (where a mesh dim splits the vocab) and gathers the rest of the
    table, reads the indices of its own block (whole over the vocab's mesh
    dims, as laid out elsewhere) and writes zeros for the others, and the
    partial lookups are summed.  DTensor's own rule fails where the indices
    are whole over a mesh dim that splits the vocab (a decode step's
    tokens): it gathers the rows before applying a mask laid out for the
    local ones.  The table's local gradient is a partial sum over every
    mesh dim that splits the indices."""
    import torch.nn.functional as F

    if not is_dtensor(table):
        return F.embedding(idx, table)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    idx = replicate_like(idx, table)
    vocab = [isinstance(p, Shard) and p.dim % 2 == 0 for p in table.placements]
    t_pl = [Shard(0) if v else Replicate() for v in vocab]
    i_pl = [Replicate() if v else p for v, p in zip(vocab, idx.placements)]
    out_pl = [Partial() if v else p for v, p in zip(vocab, i_pl)]
    grad_pl = [Shard(0) if v else Partial() if isinstance(p, Shard)
               else Replicate() for v, p in zip(vocab, i_pl)]
    rows = table.shape[0]

    def local(i, t):
        lo, block = 0, rows
        for d, v in enumerate(vocab):
            if v:
                block //= mesh.size(d)
                lo += mesh.get_coordinate()[d] * block
        here = (i >= lo) & (i < lo + block)
        out = F.embedding(torch.where(here, i - lo, 0), t)
        return out * here[..., None].to(out.dtype)

    out = local_map(local, out_placements=out_pl, in_placements=(i_pl, t_pl),
                    in_grad_placements=(i_pl, grad_pl), device_mesh=mesh,
                    redistribute_inputs=True)(idx, table)
    return out.redistribute(mesh, [Replicate() if isinstance(p, Partial)
                                   else p for p in out.placements])


_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for an (..., k) activation and a (k, n) weight; through
    ``einsum``'s local product when either is a DTensor."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    lead = _LETTERS[:x.ndim - 1]
    return einsum(f"{lead}y,yz->{lead}z", x, w)


def rowwise(fn, x: torch.Tensor, *params: torch.Tensor) -> torch.Tensor:
    """``fn(x, *params)`` for an ``fn`` that maps each row of ``x``'s last
    dim on its own (a norm); when ``x`` is a DTensor, on each rank's local
    rows: ``x`` with its last dim whole, ``params`` replicated, the result
    laid out as ``x``.  A parameter's local gradient is a partial sum over
    every mesh dim that splits the rows."""
    if not is_dtensor(x):
        return fn(x, *params)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    last = x.ndim - 1
    pl = [p if isinstance(p, Shard) and p.dim % x.ndim != last
          else Replicate() for p in x.placements]
    rep = [Replicate()] * len(pl)
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    ps = [replicate_like(q, x) for q in params]
    return local_map(fn, out_placements=pl,
                     in_placements=(pl,) + (rep,) * len(ps),
                     in_grad_placements=(pl,) + (grad,) * len(ps),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(
        x, *ps)


def replicate_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x``, the same on every rank, replicated over ``ref``'s mesh when
    ``ref`` is a DTensor; else ``x``."""
    if not is_dtensor(ref) or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def full_value(x: torch.Tensor) -> torch.Tensor:
    """The whole of ``x`` on this rank: a DTensor's full tensor (a
    collective: every rank calls it), a plain tensor itself."""
    return x.full_tensor() if is_dtensor(x) else x


def logical_spec(shape: Sequence[int], axes: Sequence[str | None]) -> tuple:
    info = _STATE.info
    if info is None:
        return ()
    return info.spec(shape, axes)


def param_shardings(axes_tree: Any, shape_tree: Any, info: MeshInfo) -> Any:
    """The placements tree from an axes tree + matching shape tree (leaves
    with a ``shape``, or shape tuples)."""
    def walk(axes: Any, shaped: Any) -> Any:
        if _is_axes(axes):
            shape = shaped if isinstance(shaped, tuple) else tuple(shaped.shape)
            return info.sharding(shape, axes)
        return {k: walk(axes[k], shaped[k]) for k in axes}

    return walk(axes_tree, shape_tree)


def distribute_tree(tree: Any, axes_tree: Any, info: MeshInfo) -> Any:
    """Every leaf of ``tree`` distributed per its logical axes."""
    if _is_axes(axes_tree):
        return info.distribute(tree, axes_tree)
    return {k: distribute_tree(tree[k], axes_tree[k], info) for k in tree}


def shard_map_specs(info: MeshInfo | None):
    """Convenience: (data_axes, model_axis) names present in the active mesh,
    for the explicit local-map MoE path."""
    if info is None:
        return (), None
    names = info.axis_names
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    model_axis = "model" if "model" in names else None
    return data_axes, model_axis
