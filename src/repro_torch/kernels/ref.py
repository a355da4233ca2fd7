"""Plain PyTorch oracles for the port's kernels (full materialization).

``attention_ref`` ports ``repro.kernels.ref.attention_ref``, widened to the
flash kernel's whole interface: ``q_offset``, ``D != Dv`` and the fused
``out * out_scale + residual`` epilogue.  A query row with no unmasked key
outputs 0 before the epilogue, as the kernel does.

``wkv_ref`` ports ``repro.kernels.ref.wkv_ref``, the per-step RWKV-6
recurrence; the model's decode step runs it too
(``models/recurrent.py::wkv_recurrent``).
"""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: float | None = None, q_offset: int = 0,
                  out_scale: float = 1.0,
                  residual: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B,Sq,Hq,D); k: (B,Skv,Hkv,D); v: (B,Skv,Hkv,Dv) -> (B,Sq,Hq,Dv)
    in q's dtype.  Positions are contiguous: pos_q = q_offset + arange(Sq),
    pos_k = arange(Skv).  Scores, softmax and the PV product run in f32."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    pos_q = q_offset + torch.arange(Sq, device=q.device)
    pos_k = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_k[None, :] <= pos_q[:, None]
    if window > 0:
        mask &= (pos_q[:, None] - pos_k[None, :]) < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None], p, 0.0)  # empty rows -> 0, not NaN
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()).reshape(B, Sq, Hq, Dv)
    if out_scale != 1.0:
        o = o * out_scale
    if residual is not None:
        o = o + residual.float()
    return o.to(q.dtype)


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            log_w: torch.Tensor, u: torch.Tensor,
            s0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence oracle.  All (B,S,H,N) f32; u (H,N); s0 (B,H,N,N).

    y_t = r_t . (S_{t-1} + (u*k_t) v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    """
    state = s0
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], log_w[:, t]  # (B, H, N)
        ys.append(torch.einsum("bhn,bhnm->bhm", rt, state)
                  + torch.einsum("bhn,hn,bhn->bh", rt, u, kt)[..., None] * vt)
        state = (torch.exp(lwt)[..., None] * state
                 + kt[..., None] * vt[:, :, None, :])
    return torch.stack(ys, 1), state
