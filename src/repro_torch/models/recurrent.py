"""Recurrent blocks: RG-LRU (Griffin [arXiv:2402.19427]) and RWKV-6 (Finch
[arXiv:2404.05892]).

Port of ``repro.models.recurrent``.  The RG-LRU recurrence
``h_t = a_t h_{t-1} + b_t`` has two forms, each taken where JAX takes its
counterpart:

* the per-step update: decode;
* ``rglru_scan``, a log-depth doubling scan over ``(a, b)`` in plain
  PyTorch (JAX's ``lax.associative_scan``; no Pallas kernel runs here):
  train, prefill and chunked prefill.

The WKV recurrence has three forms, as in JAX, and each mode takes the one
JAX takes:

* ``wkv_recurrent``, the per-step scan: decode;
* ``wkv_chunked``, the chunked-parallel form (intra-chunk attention-like
  products in log-decay space plus an inter-chunk state carry): train, and
  the kernel's plain version on a CPU tensor;
* the hand-written CUDA kernel behind ``kops.linear_scan``: prefill and
  chunked prefill.

Caches are updated in place, as everywhere in the port: RG-LRU writes its
``h`` and ``conv`` states, the time mix writes the cache's ``S`` and
``x_tm`` with ``copy_`` after reading them, the channel mix writes
``x_cm``.  In decode, an ``active`` mask keeps an inactive slot's state bit
for bit.

Under a mesh JAX's constraints are kept (``rwkv_heads`` on r, k, v and
log_w; ``lru_width`` on RG-LRU's input), the products run on local shards
(``sharding.einsum`` / ``matmul``), and every scan -- the WKV forms, RG-LRU's
conv and doubling scan -- runs in ``shard_map`` on each rank's (batch,
heads or width) shard, the sequence whole.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (constrain, current_mesh_info,
                                              einsum, is_dtensor, matmul,
                                              replicate_like, rowwise,
                                              shard_map)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import wkv_ref as wkv_recurrent
from repro_torch.models.layers import Param, dense_init, torch_dtype
from repro_torch.utils import Spec

RG_LRU_C = 8.0  # Griffin's fixed gate exponent


def _local(fn, args: tuple, axes: tuple, outs: list):
    """``fn(*args)``; under a mesh, on each rank's local shards
    (``shard_map``), each arg laid out by its logical axes in ``axes`` and
    each output by its ``(shape, axes)`` in ``outs``.  The recurrences here
    run along the sequence (dim 1), which none of these layouts splits, and
    are independent across the split dims, so a rank runs its own rows and
    channels whole: no DTensor op sees the scan (torch 2.11's DTensor has
    no rule for ``cumsum``'s backward, a ``flip``, and fails in ``pad``)."""
    info = current_mesh_info()
    if info is None or not is_dtensor(args[0]):
        return fn(*args)
    spec = info.spec
    out_specs = [spec(shape, ax) for shape, ax in outs]
    return shard_map(fn, in_specs=tuple(spec(a.shape, ax)
                                        for a, ax in zip(args, axes)),
                     out_specs=out_specs if len(outs) > 1 else out_specs[0])(
        *args)


# ---------------------------------------------------------------------------
# RG-LRU recurrent block
# ---------------------------------------------------------------------------


def init_rglru(gen: torch.Generator | None, cfg: ModelConfig, *,
               stack: int = 0, device: torch.device | str = "cuda") -> dict:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    dt, tdt = cfg.param_dtype, torch_dtype(cfg.param_dtype)
    lead = (stack,) if stack else ()
    kw = dict(stack=stack, device=device)

    def zeros(shape):
        return torch.zeros(lead + shape, dtype=tdt, device=device)

    # Lambda init so a = exp(-c*softplus(lam)) ~ U[0.9, 0.999]  (Griffin A.2)
    a0 = torch.empty(lead + (w,), dtype=torch.float32, device=device)
    a0.uniform_(0.9, 0.999, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(a0) / RG_LRU_C))
    return {
        "w_y": Param(dense_init(gen, (d, w), 1, dt, **kw),
                     ("embed_fsdp", "lru_width")),
        "w_x": Param(dense_init(gen, (d, w), 1, dt, **kw),
                     ("embed_fsdp", "lru_width")),
        "conv_w": Param(zeros((cfg.conv_width, w)), (None, "lru_width")),
        "conv_b": Param(zeros((w,)), ("lru_width",)),
        "w_a": Param(dense_init(gen, (w, w), 1, dt, **kw),
                     ("lru_width", "lru_width")),
        "b_a": Param(zeros((w,)), ("lru_width",)),
        "w_i": Param(dense_init(gen, (w, w), 1, dt, **kw),
                     ("lru_width", "lru_width")),
        "b_i": Param(zeros((w,)), ("lru_width",)),
        "lam": Param(lam, ("lru_width",)),
        "w_o": Param(dense_init(gen, (w, d), 1, dt, **kw),
                     ("lru_width", "embed_fsdp")),
    }


def rglru_state_specs(batch: int, cfg: ModelConfig) -> dict:
    w = cfg.lru_width or cfg.d_model
    f32 = torch.float32
    return {
        "h": Spec((batch, w), f32, ("batch", "lru_width")),
        "conv": Spec((batch, cfg.conv_width - 1, w), f32,
                     ("batch", None, "lru_width")),
    }


def make_rglru_state(batch: int, cfg: ModelConfig,
                     device: torch.device | str = "cuda") -> dict:
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in rglru_state_specs(batch, cfg).items()}


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds (width is tiny)."""
    cw, S = w.shape[0], u.shape[1]
    out = u * w[-1]
    for i in range(1, cw):
        shifted = F.pad(u, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[-1 - i]
    return out + b


def _conv_history(u: torch.Tensor, cw: int) -> torch.Tensor:
    """The last cw-1 rows of the pre-conv history; a prompt shorter than
    that is left-padded with zeros, the conv's implicit padding (JAX keeps
    the short history, which no (B, cw-1, w) slot can hold)."""
    tail = u[:, -(cw - 1):]
    return F.pad(tail, (0, 0, cw - 1 - tail.shape[1], 0))


def _rg_gates(p: dict, cfg: ModelConfig, u: torch.Tensor):
    """(log_a, gated), f32, from ``u`` in the compute dtype: the gate
    products run in that dtype, ``b_a``, ``b_i`` and ``lam`` are read in
    f32."""
    r = torch.sigmoid(matmul(u, p["w_a"].to(u.dtype)).float()
                      + p["b_a"].float())
    i = torch.sigmoid(matmul(u, p["w_i"].to(u.dtype)).float()
                      + p["b_i"].float())
    log_a = -RG_LRU_C * F.softplus(p["lam"].float()) * r
    mult = torch.sqrt(-torch.expm1(2.0 * log_a))
    gated = u.float() * i * mult
    return log_a, gated


def rglru_scan(a: torch.Tensor, b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0``
    along dim 1: ``(a_cum, h)`` with ``a_cum_t = prod_{s<=t} a_s``.

    Hillis-Steele doubling, ceil(log2 S) steps of JAX's associative binop
    ``(a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)``: each step combines every
    element with the one ``d`` back (an identity ``(1, 0)`` before the
    start).  Only products of ``a`` in (0, 1]: nothing is divided by a
    cumulative product, and ``a = exp(log_a)`` with ``log_a <= 0`` is the
    only exp.  Out of place, so autograd takes it as it is."""
    d, S = 1, a.shape[1]
    while d < S:
        b = b + a * F.pad(b[:, :-d], (0, 0, d, 0))
        a = a * F.pad(a[:, :-d], (0, 0, d, 0), value=1.0)
        d *= 2
    return a, b


def apply_rglru(p: dict, cfg: ModelConfig, x: torch.Tensor,
                state: dict | None, mode: str,
                active: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict | None]:
    """``mode``: train (no state), prefill, chunk_prefill (continues
    ``state``) or decode (one token; ``active`` keeps an inactive slot's
    state bit for bit).  ``conv_w`` and ``conv_b`` are read in f32 at every
    use, the scan runs in f32, and ``h`` is cast to the compute dtype
    before ``w_o``."""
    cdt = torch_dtype(cfg.compute_dtype)
    cw = cfg.conv_width
    y_gate = F.gelu(matmul(x, p["w_y"].to(cdt)), approximate="tanh")
    u_pre = constrain(matmul(x, p["w_x"].to(cdt)), "batch", None, "lru_width")
    w_c, b_c = p["conv_w"].float(), p["conv_b"].float()

    if mode == "decode":
        conv_cache = state["conv"]  # (B, cw-1, w) holds u_{t-cw+1..t-1}
        u = (u_pre[:, 0].float() * w_c[-1]
             + einsum("bcw,cw->bw", conv_cache, w_c[:-1]) + b_c)
        log_a, gated = _rg_gates(p, cfg, u[:, None, :].to(cdt))
        h = torch.exp(log_a[:, 0]) * state["h"] + gated[:, 0]
        conv_new = torch.cat([conv_cache[:, 1:], u_pre.float()], dim=1)
        if active is not None:  # inactive slots keep their state verbatim
            h = torch.where(active[:, None], h, state["h"])
            conv_new = torch.where(active[:, None, None], conv_new, conv_cache)
        state["h"].copy_(h)
        state["conv"].copy_(conv_new)
        out = matmul(y_gate * h[:, None, :].to(cdt), p["w_o"].to(cdt))
        return constrain(out, "batch", None, "embed_fsdp"), state

    u_hist = u_pre.float()
    if mode == "chunk_prefill":
        # carry the causal-conv window across chunks: prepend the cached
        # u-history, convolve, then drop the history rows (a fresh state is
        # zeros, which is the conv's own zero padding)
        u_hist = torch.cat([state["conv"], u_hist], dim=1)
    ax = ("batch", None, "lru_width")
    u = _local(_causal_conv, (u_hist, w_c, b_c),
               (ax, (None, "lru_width"), ("lru_width",)),
               [(u_hist.shape, ax)])
    if mode == "chunk_prefill":
        u = u[:, cw - 1:]
    log_a, gated = _rg_gates(p, cfg, u.to(cdt))
    a_cum, h = _local(rglru_scan, (torch.exp(log_a), gated), (ax, ax),
                      [(gated.shape, ax)] * 2)
    if mode == "chunk_prefill":
        h = h + a_cum * state["h"][:, None, :]

    if state is not None and mode in ("prefill", "chunk_prefill"):
        B, _, w = u_hist.shape
        state["conv"].copy_(_local(functools.partial(_conv_history, cw=cw),
                                   (u_hist,), (ax,), [((B, cw - 1, w), ax)]))
        state["h"].copy_(h[:, -1])
    out = matmul(y_gate * h.to(cdt), p["w_o"].to(cdt))
    return constrain(out, "batch", None, "embed_fsdp"), state


# ---------------------------------------------------------------------------
# RWKV-6 (Finch)
# ---------------------------------------------------------------------------

_N_MIX = 5  # w, k, v, r, g ddlerp streams


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    return cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size


def init_rwkv_time_mix(gen: torch.Generator | None, cfg: ModelConfig, *,
                       stack: int = 0,
                       device: torch.device | str = "cuda") -> dict:
    d = cfg.d_model
    h, n = _heads(cfg)
    lm, ld = cfg.rwkv_mix_lora, cfg.rwkv_decay_lora
    dt, tdt = cfg.param_dtype, torch_dtype(cfg.param_dtype)
    lead = (stack,) if stack else ()
    kw = dict(stack=stack, device=device)

    def full(shape, value, dtype=tdt):
        return torch.full(lead + shape, value, dtype=dtype, device=device)

    # decay base: -6 .. -1 ramp => per-channel half-lives spanning decades
    ramp = torch.linspace(0.0, 1.0, d, dtype=torch.float32, device=device)
    w0 = (-6.0 + 5.0 * ramp ** 1.3).expand(lead + (d,)).clone()
    u = torch.empty(lead + (h, n), dtype=torch.float32, device=device)
    u.normal_(0.0, 0.1, generator=gen)
    return {
        "mu_x": Param(full((d,), 0.5), (None,)),
        "mu": Param(full((_N_MIX, d), 0.5), (None, None)),
        "mix_A": Param(dense_init(gen, (d, _N_MIX, lm), 1, dt, **kw),
                       ("embed_fsdp", None, "lora")),
        "mix_B": Param(dense_init(gen, (_N_MIX, lm, d), 2, dt, **kw),
                       (None, "lora", None)),
        "w0": Param(w0, (None,)),
        "decay_A": Param(dense_init(gen, (d, ld), 1, dt, **kw),
                         ("embed_fsdp", "lora")),
        "decay_B": Param(dense_init(gen, (ld, d), 1, dt, **kw),
                         ("lora", None)),
        "u": Param(u.to(tdt), ("rwkv_heads", None)),
        "w_r": Param(dense_init(gen, (d, d), 1, dt, **kw),
                     ("embed_fsdp", "mlp")),
        "w_k": Param(dense_init(gen, (d, d), 1, dt, **kw),
                     ("embed_fsdp", "mlp")),
        "w_v": Param(dense_init(gen, (d, d), 1, dt, **kw),
                     ("embed_fsdp", "mlp")),
        "w_g": Param(dense_init(gen, (d, d), 1, dt, **kw),
                     ("embed_fsdp", "mlp")),
        "ln_w": Param(full((d,), 1.0), (None,)),
        "ln_b": Param(full((d,), 0.0), (None,)),
        "w_o": Param(dense_init(gen, (d, d), 1, dt, **kw),
                     ("mlp", "embed_fsdp")),
    }


def init_rwkv_channel_mix(gen: torch.Generator | None, cfg: ModelConfig, *,
                          stack: int = 0,
                          device: torch.device | str = "cuda") -> dict:
    d, ff, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    lead = (stack,) if stack else ()
    kw = dict(stack=stack, device=device)
    half = torch.full(lead + (d,), 0.5, dtype=torch_dtype(dt), device=device)
    return {
        "mu_k": Param(half, (None,)),
        "mu_r": Param(half.clone(), (None,)),
        "w_k": Param(dense_init(gen, (d, ff), 1, dt, **kw),
                     ("embed_fsdp", "mlp")),
        "w_v": Param(dense_init(gen, (ff, d), 1, dt, **kw),
                     ("mlp", "embed_fsdp")),
        "w_r": Param(dense_init(gen, (d, d), 1, dt, **kw),
                     ("embed_fsdp", "mlp")),
    }


def rwkv_state_specs(batch: int, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h, n = _heads(cfg)
    f32 = torch.float32
    return {
        "S": Spec((batch, h, n, n), f32, ("batch", "rwkv_heads", None, None)),
        "x_tm": Spec((batch, d), f32, ("batch", None)),
        "x_cm": Spec((batch, d), f32, ("batch", None)),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """xx_t = x_{t-1}; token 0 sees ``prev`` (decode state) or zeros."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p: dict, x: torch.Tensor, xx: torch.Tensor):
    """Finch data-dependent token-shift mixes for the 5 streams.  Under a
    mesh the (5, lora) mix dims stay whole: DTensor cannot view a split
    5 x lora dim back into its two factors."""
    dx = xx - x
    z = x + dx * p["mu_x"].to(x.dtype)
    za = torch.tanh(einsum("bsd,dkl->bskl", z, p["mix_A"].to(x.dtype)))
    za = constrain(za, "batch", "seq_act", None, None)
    mixes = (p["mu"].to(x.dtype)
             + einsum("bskl,kld->bskd", za, p["mix_B"].to(x.dtype)))
    return tuple(x + dx * mixes[:, :, i] for i in range(_N_MIX))  # w,k,v,r,g


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked-parallel WKV6.  All (B,S,H,N) in f32; s0 (B,H,N,N).

    y_t = r_t . (S_{t-1} + (u*k_t) v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    """
    S = r.shape[1]
    c = min(chunk, S)
    while S % c:
        c -= 1
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)[None, :, :, None, None]
    state = s0
    ys = []
    for c0 in range(0, S, c):
        rc, kc, vc, lwc = (a[:, c0:c0 + c] for a in (r, k, v, log_w))
        p = torch.cumsum(lwc, dim=1)  # inclusive log-decay
        p_prev = p - lwc  # exclusive (through t-1)
        y_inter = torch.einsum("blhn,bhnm->blhm", rc * torch.exp(p_prev), state)
        # intra-chunk: A[t,s] = sum_n r_t[n] k_s[n] exp(p_prev[t,n] - p[s,n]), s<t
        diff = p_prev[:, :, None] - p[:, None, :]  # (B, c, c, H, N)
        D = torch.where(tri, torch.exp(diff), 0.0)
        A = torch.einsum("blhn,bmhn,blmhn->blmh", rc, kc, D)
        y_intra = torch.einsum("blmh,bmhn->blhn", A, vc)
        bonus = torch.einsum("blhn,hn,blhn->blh", rc, u, kc)
        ys.append(y_inter + y_intra + bonus[..., None] * vc)
        k_hat = kc * torch.exp(p[:, -1:] - p)
        state = (torch.exp(p[:, -1])[..., None] * state
                 + torch.einsum("blhn,blhm->bhnm", k_hat, vc))
    return torch.cat(ys, dim=1), state


def _group_norm(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor, n: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head norm of each token's ``d = heads x n`` channels; under a
    mesh on each rank's own rows, as ``apply_norm``."""
    return rowwise(functools.partial(_group_norm_rows, n=n, eps=eps), y, w, b)


def _group_norm_rows(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                     n: int, eps: float) -> torch.Tensor:
    B, S, d = y.shape
    yh = y.reshape(B, S, d // n, n).float()
    mean = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    yh = (yh - mean) * torch.rsqrt(var + eps)
    return (yh.reshape(B, S, d) * w.float() + b.float()).to(y.dtype)


def apply_rwkv_time_mix(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        state: dict | None, mode: str,
                        active: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, dict | None]:
    cdt = torch_dtype(cfg.compute_dtype)
    B, S, d = x.shape
    h, n = _heads(cfg)

    # chunk_prefill continues a prefix: token 0 shifts against the cached
    # last-token activation (zeros when fresh, == _shift's zero pad)
    prev = (state["x_tm"] if (state is not None
                              and mode in ("decode", "chunk_prefill"))
            else None)
    xx = _shift(x, prev)
    xw, xk, xv, xr, xg = _ddlerp(p, x, xx)

    r = matmul(xr, p["w_r"].to(cdt)).reshape(B, S, h, n)
    k = matmul(xk, p["w_k"].to(cdt)).reshape(B, S, h, n)
    v = matmul(xv, p["w_v"].to(cdt)).reshape(B, S, h, n)
    g = matmul(xg, p["w_g"].to(cdt))
    # decay_B and u are read in f32, as JAX reads them
    w_raw = (p["w0"].float()
             + matmul(torch.tanh(matmul(xw, p["decay_A"].to(cdt))).float(),
                      p["decay_B"].float()))
    log_w = -torch.exp(w_raw).reshape(B, S, h, n)

    heads = ("batch", None, "rwkv_heads", None)
    r32, k32, v32 = (constrain(a.float().contiguous(), *heads)
                     for a in (r, k, v))
    log_w = constrain(log_w, *heads)
    u = p["u"].float().contiguous()
    s0 = (state["S"] if state is not None else replicate_like(
        torch.zeros((B, h, n, n), dtype=torch.float32, device=x.device), r32))

    if mode == "decode":
        scan = wkv_recurrent
    elif mode in ("prefill", "chunk_prefill"):
        def scan(*a):
            return kops.linear_scan(*(t.contiguous() for t in a))
    else:  # train: the differentiable chunked form (the kernel has no backward)
        scan = wkv_chunked
    state_ax = ("batch", "rwkv_heads", None, None)
    y, s_fin = _local(scan, (r32, k32, v32, log_w, u, s0),
                      (heads,) * 4 + (("rwkv_heads", None), state_ax),
                      [(r32.shape, heads), (s0.shape, state_ax)])

    y = _group_norm(y.reshape(B, S, d).to(cdt), p["ln_w"], p["ln_b"], n)
    out = constrain(matmul(y * F.silu(g), p["w_o"].to(cdt)),
                    "batch", "seq_act", None)

    if state is not None:
        x_tm = x[:, -1].float()
        if active is not None:  # inactive slots keep their state verbatim
            s_fin = torch.where(active[:, None, None, None], s_fin, state["S"])
            x_tm = torch.where(active[:, None], x_tm, state["x_tm"])
        state["S"].copy_(s_fin)
        state["x_tm"].copy_(x_tm)
    return out, state


def apply_rwkv_channel_mix(p: dict, cfg: ModelConfig, x: torch.Tensor,
                           state: dict | None, mode: str,
                           active: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, dict | None]:
    cdt = torch_dtype(cfg.compute_dtype)
    prev = (state["x_cm"] if (state is not None
                              and mode in ("decode", "chunk_prefill"))
            else None)
    xx = _shift(x, prev)
    dx = xx - x
    xk = x + dx * p["mu_k"].to(cdt)
    xr = x + dx * p["mu_r"].to(cdt)
    kk = torch.square(torch.relu(matmul(xk, p["w_k"].to(cdt))))
    out = constrain(torch.sigmoid(matmul(xr, p["w_r"].to(cdt)))
                    * matmul(kk, p["w_v"].to(cdt)), "batch", "seq_act", None)
    if state is not None:
        x_cm = x[:, -1].float()
        if active is not None:
            x_cm = torch.where(active[:, None], x_cm, state["x_cm"])
        state["x_cm"].copy_(x_cm)
    return out, state
