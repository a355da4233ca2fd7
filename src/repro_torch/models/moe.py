"""Mixture-of-Experts: top-k router + capacity dispatch + expert parallelism.

Port of ``repro.models.moe``, with its two execution paths (identical math,
parity-tested):

* ``_moe_dense`` -- every expert over every token; used without a mesh and,
  under one, for few tokens (<= ``_SMALL_T``), where a capacity all-to-all
  would be all overhead.  Under a mesh the experts stay sharded over the
  model axis (DTensor placements) and the combine reduces over it.
* ``_moe_shard_map`` -- the production train/prefill path under a mesh: a
  ``local_map`` over (batch over pod/data, sequence over model) in which
  each rank all-gathers its FSDP shards of the expert weights over the data
  axis, scatters its tokens into GShard-style capacity buffers of
  ``_capacity`` slots per expert, exchanges them over the model ("expert")
  axis with an all-to-all, runs its experts, and sends the results back.
  The collectives are differentiable (``distributed/collectives.py``).
  Over-capacity (token, slot) assignments are dropped (the residual passes
  through), matching GShard semantics; ``capacity_factor = n_experts /
  top_k`` gives ``cap >= T`` and drops nothing.

Router: logits and softmax in f32 (the router weight is read in f32 at
every use, ``moe.py:70``), top-k, gates renormalised by their sum, and the
Switch load-balancing loss E * sum_e f_e p_e with f_e from the top-1
assignment (on the shard_map path each rank's loss over its own tokens,
averaged over every mesh axis).

``PATH_CALLS`` counts the calls of each path (a recomputed layer counts
again); ``DROPS``, when set to a list, collects one (dropped, total) pair of
(token, slot) counts per ``_moe_shard_map`` call, as 0-d tensors.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import (all_gather_tiled,
                                                 all_to_all_tiled, pmean)
from repro_torch.distributed.sharding import (constrain, current_mesh_info,
                                              einsum, is_dtensor, matmul,
                                              shard_map, shard_map_specs)
from repro_torch.models.layers import Param, _act, dense_init, torch_dtype

_SMALL_T = 4096  # global token threshold below which the dense path wins

PATH_CALLS = {"dense": 0, "shard_map": 0}
DROPS: list | None = None


def init_moe(gen: torch.Generator | None, cfg: ModelConfig, *, stack: int = 0,
             device: torch.device | str = "cuda") -> dict:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    dt = cfg.param_dtype
    kw = dict(stack=stack, device=device)
    return {
        "router": Param(dense_init(gen, (d, e), 1, dt, **kw),
                        ("embed_fsdp", None)),
        "w_gate": Param(dense_init(gen, (e, d, ff), 2, dt, **kw),
                        ("experts", "embed_fsdp", None)),
        "w_up": Param(dense_init(gen, (e, d, ff), 2, dt, **kw),
                      ("experts", "embed_fsdp", None)),
        "w_down": Param(dense_init(gen, (e, ff, d), 2, dt, **kw),
                        ("experts", "expert_ff_fsdp", None)),
    }


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``F.one_hot(idx, n).to(dtype)``; on plain tensors without its range
    check, whose ``.item()`` reads would stop a decode step's CUDA graph
    capture (``PagedServingEngine._tick_block``; top-k indices are in
    range).  A DTensor (the dense path under a mesh) keeps ``F.one_hot``."""
    if is_dtensor(idx):
        return F.one_hot(idx, n).to(dtype)
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _route(router_w: torch.Tensor, x2d: torch.Tensor, cfg: ModelConfig):
    """(gates (T, K) f32, expert indices (T, K), aux loss) for x2d (T, d).
    ``torch.topk`` and ``lax.top_k`` may order equal probabilities
    differently; with seeded random weights no two are equal."""
    logits = matmul(x2d.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    e = cfg.n_experts
    me = probs.mean(0)  # mean router probability per expert
    fe = _one_hot(idx[:, 0], e, torch.float32).mean(0)  # top-1 fraction
    aux = e * (fe * me).sum()
    return gates, idx, aux


def _moe_dense(p: dict, cfg: ModelConfig,
               x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Every expert over every token, (T, E, d_ff_expert) a layer, then the
    gate-weighted combine through a one-hot in the compute dtype
    (``moe.py:88-105``)."""
    cdt = torch_dtype(cfg.compute_dtype)
    B, S, d = x.shape
    # the fold of (batch, seq) into tokens keeps only a leading split: under
    # a mesh the sequence is gathered first
    x2d = constrain(x, "batch", None, None).reshape(-1, d)
    gates, idx, aux = _route(p["router"], x2d, cfg)
    h = einsum("td,edf->tef", x2d, p["w_gate"].to(cdt))
    u = einsum("td,edf->tef", x2d, p["w_up"].to(cdt))
    h = constrain(_act(cfg, h) * u, None, "experts", None)
    y_e = einsum("tef,efd->ted", h, p["w_down"].to(cdt))
    y_e = constrain(y_e, None, "experts", None)
    sel = _one_hot(idx, cfg.n_experts, cdt)  # (T, K, E)
    w_comb = einsum("tk,tke->te", gates.to(cdt), sel)
    y = einsum("te,ted->td", w_comb, y_e)
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# local_map capacity-dispatch path
# ---------------------------------------------------------------------------


def _capacity(tokens_local: int, cfg: ModelConfig) -> int:
    c = int(tokens_local * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def _slot_positions(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (token, slot) assignment's place in its expert's buffer: the
    number of earlier assignments, in (t, k) row-major order, to the same
    expert."""
    # expert-major, so the scan runs along the contiguous dim (a scan down
    # the T*K rows of a (T*K, E) one-hot takes ~14 ms a layer on an H100)
    onehot = F.one_hot(flat_e, n_experts).t()  # (E, T*K)
    pos = torch.cumsum(onehot, dim=1) - onehot  # exclusive count
    return pos.gather(0, flat_e[None, :])[0]


def _dispatch_compute_combine(x_l, router_l, wg_l, wu_l, wd_l, *,
                              cfg: ModelConfig, data_group, model_group,
                              all_groups: tuple):
    """One rank's tokens ``x_l`` (b_l, s_l, d) through the experts, with its
    shards of the router (d_shard, E) and of the expert weights (E_l,
    d_shard, ff), (E_l, ff_shard, d) (``moe.py:117-182``)."""
    cdt = torch_dtype(cfg.compute_dtype)
    b_l, s_l, d = x_l.shape
    E, K = cfg.n_experts, cfg.top_k

    # FSDP gathers (weights stored sharded over the data axis)
    router_w, w_gate, w_up, w_down = router_l, wg_l, wu_l, wd_l
    if data_group is not None:
        router_w = all_gather_tiled(router_l, 0, data_group)
        w_gate = all_gather_tiled(wg_l, 1, data_group)
        w_up = all_gather_tiled(wu_l, 1, data_group)
        w_down = all_gather_tiled(wd_l, 1, data_group)

    x2d = x_l.reshape(-1, d)  # (T_l, d)
    t_l = x2d.shape[0]
    gates, idx, aux = _route(router_w, x2d, cfg)
    cap = _capacity(t_l, cfg)

    flat_e = idx.reshape(-1)  # (T_l*K,) row-major (t, k)
    pos = _slot_positions(flat_e, E)
    keep = pos < cap
    pos_c = torch.clamp(pos, max=cap - 1)
    if DROPS is not None:
        DROPS.append(((~keep).sum().detach(), keep.numel()))

    # a dropped assignment adds a zero at slot cap-1, so the slot's kept
    # token is unchanged
    x_rep = x2d.repeat_interleave(K, dim=0).to(cdt)  # (T_l*K, d)
    val = torch.where(keep[:, None], x_rep, 0)
    buf = torch.zeros((E, cap, d), dtype=cdt, device=x_l.device)
    buf = buf.index_put((flat_e, pos_c), val, accumulate=True)

    # expert-parallel exchange: (E, cap, d) -> (E_l, cap * ep, d)
    buf = all_to_all_tiled(buf, 0, 1, model_group)
    h = torch.einsum("ecd,edf->ecf", buf, w_gate.to(cdt))
    u = torch.einsum("ecd,edf->ecf", buf, w_up.to(cdt))
    y = torch.einsum("ecf,efd->ecd", _act(cfg, h) * u, w_down.to(cdt))
    y = all_to_all_tiled(y, 1, 0, model_group)  # back to (E, cap, d)

    # combine: gather back per (token, slot), weight by gates, drop overflow.
    # A row gather of the flattened buffer: its backward is an index_add
    # (a dropped assignment adds a zero), not advanced indexing's sort
    picked = y.reshape(E * cap, d).index_select(0, flat_e * cap + pos_c)
    picked = torch.where(keep[:, None], picked, 0)
    out = (picked.reshape(t_l, K, d) * gates.to(cdt)[..., None]).sum(dim=1)
    return out.reshape(b_l, s_l, d), pmean(aux, all_groups)


def _moe_shard_map(p: dict, cfg: ModelConfig,
                   x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    info = current_mesh_info()
    _, model_axis = shard_map_specs(info)
    names = info.axis_names
    data_axis = "data" if "data" in names else None
    batch_spec = tuple(a for a in ("pod", "data") if a in names)
    bs = batch_spec[0] if len(batch_spec) == 1 else (batch_spec or None)
    mesh = info.mesh
    fn = functools.partial(
        _dispatch_compute_combine, cfg=cfg,
        data_group=None if data_axis is None else mesh.get_group(data_axis),
        model_group=mesh.get_group(model_axis),
        all_groups=tuple(mesh.get_group(a) for a in names))
    w_spec = (model_axis, data_axis, None)
    return shard_map(fn, in_specs=(
        (bs, model_axis, None),  # x: batch over DP axes, seq over model
        (data_axis, None),  # router
        w_spec, w_spec, w_spec),
        out_specs=[(bs, model_axis, None), ()])(
        x, p["router"], p["w_gate"], p["w_up"], p["w_down"])


def _shard_map_viable(cfg: ModelConfig, x: torch.Tensor) -> bool:
    info = current_mesh_info()
    if info is None or "model" not in info.axis_names:
        return False
    B, S, _ = x.shape
    if B * S <= _SMALL_T:
        return False
    mdl = info.axis_size("model")
    dp = info.axis_size("data") * info.axis_size("pod")
    return (B % dp == 0 and S % mdl == 0 and cfg.n_experts % mdl == 0
            and cfg.d_model % info.axis_size("data") == 0)


def apply_moe(p: dict, cfg: ModelConfig,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if _shard_map_viable(cfg, x):
        PATH_CALLS["shard_map"] += 1
        return _moe_shard_map(p, cfg, x)
    PATH_CALLS["dense"] += 1
    return _moe_dense(p, cfg, x)
