"""Mixture-of-Experts: top-k router over every expert computed densely.

Port of ``repro.models.moe``'s single-device path: ``apply_moe`` always
runs ``_moe_dense``, as JAX does without a mesh (``_shard_map_viable`` is
false there).  Every expert runs over every token, so no token is dropped:
the capacity buffers and the expert-parallel all-to-all belong to
``_moe_shard_map``, which waits for the distributed slice.

Router: logits and softmax in f32 (the router weight is read in f32 at
every use, ``moe.py:70``), top-k, gates renormalised by their sum, and the
Switch load-balancing loss E * sum_e f_e p_e with f_e from the top-1
assignment.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _act, dense_init, torch_dtype


def init_moe(gen: torch.Generator | None, cfg: ModelConfig, *, stack: int = 0,
             device: torch.device | str = "cuda") -> dict:
    d, e, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    dt = cfg.param_dtype
    kw = dict(stack=stack, device=device)
    return {
        "router": dense_init(gen, (d, e), 1, dt, **kw),
        "w_gate": dense_init(gen, (e, d, ff), 2, dt, **kw),
        "w_up": dense_init(gen, (e, d, ff), 2, dt, **kw),
        "w_down": dense_init(gen, (e, ff, d), 2, dt, **kw),
    }


def _route(router_w: torch.Tensor, x2d: torch.Tensor, cfg: ModelConfig):
    """(gates (T, K) f32, expert indices (T, K), aux loss) for x2d (T, d).
    ``torch.topk`` and ``lax.top_k`` may order equal probabilities
    differently; with seeded random weights no two are equal."""
    logits = x2d.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    e = cfg.n_experts
    me = probs.mean(0)  # mean router probability per expert
    fe = F.one_hot(idx[:, 0], e).float().mean(0)  # top-1 fraction
    aux = e * (fe * me).sum()
    return gates, idx, aux


def _moe_dense(p: dict, cfg: ModelConfig,
               x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Every expert over every token, (T, E, d_ff_expert) a layer, then the
    gate-weighted combine through a one-hot in the compute dtype
    (``moe.py:88-105``)."""
    cdt = torch_dtype(cfg.compute_dtype)
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    gates, idx, aux = _route(p["router"], x2d, cfg)
    h = torch.einsum("td,edf->tef", x2d, p["w_gate"].to(cdt))
    u = torch.einsum("td,edf->tef", x2d, p["w_up"].to(cdt))
    y_e = torch.einsum("tef,efd->ted", _act(cfg, h) * u, p["w_down"].to(cdt))
    sel = F.one_hot(idx, cfg.n_experts).to(cdt)  # (T, K, E)
    w_comb = torch.einsum("tk,tke->te", gates.to(cdt), sel)
    y = torch.einsum("te,ted->td", w_comb, y_e)
    return y.reshape(B, S, d), aux


def apply_moe(p: dict, cfg: ModelConfig,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _moe_dense(p, cfg, x)
