"""Plain float32 forward of RWKV-6 (Finch, arXiv:2404.05892), written from
the layer equations.

    x = LayerNorm0(E[tokens])
    per layer:
      h = LayerNorm(x) * norm1 + b1;  h' = h shifted one token (0 first)
      z = h + (h' - h) mu_x;  m_i = mu_i + tanh(z A) B_i   (i = w, k, v, r, g)
      x_i = h + (h' - h) m_i
      r, k, v, g = x_r Wr, x_k Wk, x_v Wv, x_g Wg         (heads of N)
      log w = -exp(w0 + tanh(x_w Da) Db)
      y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
      y = GroupNorm_heads(y) * ln_w + ln_b  (eps group_norm_eps)
      x = x + (y * silu(g)) Wo
      h = LayerNorm(x) * norm2 + b2;  h' shifted;  k' = h + (h' - h) mu_k
      r' = h + (h' - h) mu_r;  x = x + sigmoid(r' Wr') * (relu(k' Wk')^2 Wv')
    logits = LayerNorm(x) Wout

The WKV recurrence runs in chunks of ``CHUNK`` tokens: inside a chunk the
pairwise decays are exp of sums of log w over the tokens between, all <= 0,
so no term overflows; between chunks the state carries.  It is the same
sum as the token-by-token recurrence, in another order.

Weights are the flat ``{path: tensor}`` of ``portbench.weights``, stacked
over layers under ``seg0/sub0/``; they are read in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import Prec, layer, layer_norm

P = "seg0/sub0"
CHUNK = 32


def wkv(r, k, v, log_w, u) -> torch.Tensor:
    """y for one sequence from a zero state: r, k, v, log_w (S, H, N);
    u (H, N)."""
    S, H, N = r.shape
    state = r.new_zeros(H, N, N)
    ys = []
    for lo in range(0, S, CHUNK):
        rc, kc, vc, lw = (t[lo:lo + CHUNK] for t in (r, k, v, log_w))
        c = rc.shape[0]
        incl = torch.cumsum(lw, 0)  # through t
        excl = incl - lw  # through t - 1
        y = torch.einsum("thn,hnm->thm", rc * torch.exp(excl), state)
        # token s < t reaches t decayed by the steps s+1 .. t-1
        dec = torch.exp(excl[:, None] - incl[None, :])  # (t, s, H, N)
        tri = torch.tril(torch.ones(c, c, dtype=torch.bool, device=r.device),
                         -1)[:, :, None, None]
        a = (rc[:, None] * kc[None, :] * torch.where(tri, dec, 0.0)).sum(-1)
        y = y + torch.einsum("tsh,shm->thm", a, vc)
        y = y + (rc * u * kc).sum(-1, keepdim=True) * vc
        ys.append(y)
        state = (torch.exp(incl[-1])[:, :, None] * state
                 + torch.einsum("thn,thm->hnm", kc * torch.exp(incl[-1] - incl),
                                vc))
    return torch.cat(ys, 0)


def _shift(h: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(h[:1]), h[:-1]], 0)


def _layer(w: dict, m: dict, i: int, x: torch.Tensor, prec: Prec):
    S, d = x.shape
    n = m["head_size"]
    H = d // n
    eps = m["layer_norm_epsilon"]

    def t(name):
        return layer(w, P, i, name)

    h = layer_norm(x, t("norm1/scale"), t("norm1/bias"), eps)
    dx = _shift(h) - h
    z = h + dx * t("core/mu_x")
    za = torch.tanh(prec.mm(z, t("core/mix_A").reshape(d, -1))).view(S, 5, -1)
    mix = t("core/mu") + prec.einsum("skl,kld->skd", za, t("core/mix_B"))
    xw, xk, xv, xr, xg = (h + dx * mix[:, j] for j in range(5))
    r = prec.mm(xr, t("core/w_r")).view(S, H, n)
    k = prec.mm(xk, t("core/w_k")).view(S, H, n)
    v = prec.mm(xv, t("core/w_v")).view(S, H, n)
    g = prec.mm(xg, t("core/w_g"))
    w_raw = t("core/w0") + prec.mm(torch.tanh(prec.mm(xw, t("core/decay_A"))),
                                   t("core/decay_B"))
    log_w = -torch.exp(w_raw).view(S, H, n)
    y = wkv(r, k, v, log_w, t("core/u")).reshape(S, H, n)
    mean = y.mean(-1, keepdim=True)
    var = (y - mean).square().mean(-1, keepdim=True)
    y = ((y - mean) * torch.rsqrt(var + m["group_norm_eps"])).reshape(S, d)
    y = y * t("core/ln_w") + t("core/ln_b")
    x = x + prec.mm(y * F.silu(g), t("core/w_o"))

    h = layer_norm(x, t("norm2/scale"), t("norm2/bias"), eps)
    dx = _shift(h) - h
    kk = torch.relu(prec.mm(h + dx * t("mlp/mu_k"), t("mlp/w_k"))).square()
    rr = torch.sigmoid(prec.mm(h + dx * t("mlp/mu_r"), t("mlp/w_r")))
    return x + rr * prec.mm(kk, t("mlp/w_v"))


def hidden(w: dict, m: dict, tokens: torch.Tensor, prec: Prec,
           remat: bool = False):
    """(final-normed hidden states (B, S, d), 0.0) of ``tokens`` (B, S)."""
    eps = m["layer_norm_epsilon"]
    rows = []
    for b in range(tokens.shape[0]):
        x = w["embed"].float()[tokens[b].long()]
        x = layer_norm(x, w["embed_ln/scale"].float(),
                       w["embed_ln/bias"].float(), eps)
        for i in range(m["num_hidden_layers"]):
            x = _layer(w, m, i, x, prec)
        rows.append(layer_norm(x, w["final_norm/scale"].float(),
                               w["final_norm/bias"].float(), eps))
    return torch.stack(rows), 0.0


def logits(w: dict, m: dict, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    return prec.mm(x, w["out"].float())
