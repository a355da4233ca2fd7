"""Plain float32 forward of a decoder with grouped-query attention, rotary
positions, RMSNorm and a top-k softmax router over GLU experts (the
``granite-moe`` configuration), written from the layer equations.

Per layer, on the residual stream x:

    h = RMSNorm(x) * norm1;  q, k, v = h Wq, h Wk, h Wv  (heads of head_dim)
    q, k = rope(q), rope(k);  head j reads key/value head j // (H / Hkv)
    x = x + (softmax(q k^T / sqrt(head_dim), causal) v) Wo
    h = RMSNorm(x) * norm2;  p = softmax(h Wr) over the experts
    the top k of p, renormalised to sum 1, weigh their experts'
    (silu(h Wg_e) * h Wu_e) Wd_e;  x = x + that sum

then RMSNorm(x) * final_norm and the logits x E^T against the tied token
table E.  Only the routed experts are computed.  The router loss is the
Switch one, E * sum_e f_e p_e, with f_e the share of tokens whose first
choice is e and p_e the mean router probability, summed over the layers.

Weights are the flat ``{path: tensor}`` of ``portbench.weights``, stacked
over layers under ``seg0/sub0/``; they are read in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import Prec, layer, rms_norm, rope

P = "seg0/sub0"
_Q_BLOCK = 1024


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               prec: Prec) -> torch.Tensor:
    """Causal attention of one sequence: q (S, H, D), k and v (S, Hkv, D)."""
    S, H, D = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    outs = []
    for lo in range(0, S, _Q_BLOCK):
        hi = min(S, lo + _Q_BLOCK)
        s = prec.einsum("qhd,khd->hqk", q[lo:hi], k[:hi]) * D ** -0.5
        mask = (torch.arange(hi, device=q.device)[None, :]
                <= torch.arange(lo, hi, device=q.device)[:, None])
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(prec.einsum("hqk,khd->qhd", p, v[:hi]))
    return torch.cat(outs, 0)


def _experts(w: dict, m: dict, i: int, h: torch.Tensor, prec: Prec):
    """(the routed experts' sum (T, d), the layer's router loss)."""
    E, K = m["num_local_experts"], m["num_experts_per_tok"]
    probs = torch.softmax(h @ layer(w, P, i, "moe/router"), dim=-1)
    gates, idx = torch.topk(probs, K, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    first = F.one_hot(idx[:, 0], E).float().mean(0)
    aux = E * (first * probs.mean(0)).sum()
    y = torch.zeros_like(h)
    wg, wu, wd = (w[f"{P}/moe/{n}"][i] for n in ("w_gate", "w_up", "w_down"))
    for e in range(E):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        x_e = h[rows]
        a = F.silu(prec.mm(x_e, wg[e].float())) * prec.mm(x_e, wu[e].float())
        y = y.index_add(0, rows, gates[rows, slot, None] * prec.mm(
            a, wd[e].float()))
    return y, aux


def _layer(w: dict, m: dict, i: int, x: torch.Tensor, prec: Prec):
    """One layer over x (B, S, d): (x, router loss)."""
    B, S, d = x.shape
    H, Hkv, D = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    eps = m["rms_norm_eps"]
    pos = torch.arange(S, device=x.device)
    h = rms_norm(x, layer(w, P, i, "norm1/scale"), eps)
    wq = layer(w, P, i, "core/w_q").reshape(d, H * D)
    wk = layer(w, P, i, "core/w_k").reshape(d, Hkv * D)
    wv = layer(w, P, i, "core/w_v").reshape(d, Hkv * D)
    wo = layer(w, P, i, "core/w_o").reshape(H * D, d)
    rows = []
    for b in range(B):
        q = rope(prec.mm(h[b], wq).view(S, H, D), pos, m["rope_theta"])
        k = rope(prec.mm(h[b], wk).view(S, Hkv, D), pos, m["rope_theta"])
        v = prec.mm(h[b], wv).view(S, Hkv, D)
        rows.append(prec.mm(_attention(q, k, v, prec).reshape(S, H * D), wo))
    x = x + torch.stack(rows)
    h = rms_norm(x, layer(w, P, i, "norm2/scale"), eps).reshape(B * S, d)
    y, aux = _experts(w, m, i, h, prec)
    return x + y.view(B, S, d), aux


def hidden(w: dict, m: dict, tokens: torch.Tensor, prec: Prec,
           remat: bool = False):
    """(final-normed hidden states (B, S, d), summed router loss) of
    ``tokens`` (B, S); ``remat`` recomputes each layer in the backward."""
    x = w["embed"].float()[tokens.long()]
    aux = x.new_zeros(())
    for i in range(m["num_hidden_layers"]):
        if remat:
            x, a = checkpoint(_layer, w, m, i, x, prec, use_reentrant=False)
        else:
            x, a = _layer(w, m, i, x, prec)
        aux = aux + a
    return rms_norm(x, w["final_norm/scale"].float(), m["rms_norm_eps"]), aux


def logits(w: dict, m: dict, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    """Logits against the tied token table."""
    return prec.mm(x, w["embed"].float().t())
