"""Shared layers: initializers, norms, positions (RoPE, M-RoPE,
sinusoids), MLPs.

Port of ``repro.models.layers``.  Weights keep the JAX layouts (``(d, ff)``
MLP matrices, ``(d,)`` norm scales); activations are ``(..., d)``.  The
``init_*`` functions build ``Param(value, axes)`` leaves, as JAX does:
``axes`` names each dim of one layer's weight with a logical sharding axis
(``repro_torch.distributed.sharding``), and ``split`` separates the value
tree from the axes tree.  Every
function that takes weights casts them to ``cfg.compute_dtype`` at use, as
JAX does; a weight already held in that dtype (see
``LanguageModel.cast_for_compute``) passes through without a copy.
"""
from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import replicate

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``param_dtype`` / ``compute_dtype``."""
    return _DTYPES[name]


class Param(NamedTuple):
    """A weight and the logical axes of one layer's copy of it (a stacked
    weight's leading ``layers`` axis is added by ``init_segment``)."""
    value: torch.Tensor
    axes: tuple[str | None, ...]


def split(tree: Any) -> tuple[Any, Any]:
    """(values, axes) from a dict tree whose leaves are ``Param``."""
    if isinstance(tree, Param):
        return tree.value, tuple(tree.axes)
    pairs = {k: split(v) for k, v in tree.items()}
    return ({k: v for k, (v, _) in pairs.items()},
            {k: a for k, (_, a) in pairs.items()})


# ---------------------------------------------------------------------------
# Initializers (explicit generators; the numbers differ from jax.random's,
# parity tests carry weights across with ``repro_torch.bridge`` instead)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: tuple[int, ...], in_dims: int,
               dtype: str, *, stack: int = 0,
               device: torch.device | str = "cuda") -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-style).  ``stack > 0`` draws a
    leading layers axis of that many independent copies (scanned segments);
    the fan-in is the per-layer one."""
    fan_in = max(1, math.prod(shape[:in_dims]))
    full = ((stack,) if stack else ()) + tuple(shape)
    w = torch.empty(full, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(1.0 / math.sqrt(fan_in)).to(torch_dtype(dtype))


def embed_init(gen: torch.Generator, shape: tuple[int, ...], dtype: str, *,
               device: torch.device | str = "cuda") -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, 0.02, generator=gen)
    return w.to(torch_dtype(dtype))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, d: int, *, stack: int = 0,
              device: torch.device | str = "cuda") -> dict:
    shape = ((stack,) if stack else ()) + (d,)
    dt = torch_dtype(cfg.param_dtype)
    p = {"scale": Param(torch.zeros(shape, dtype=dt, device=device)
                        if cfg.gemma_norm
                        else torch.ones(shape, dtype=dt, device=device), (None,))}
    if cfg.norm_type == "layernorm":
        p["bias"] = Param(torch.zeros(shape, dtype=dt, device=device), (None,))
    return p


def apply_norm(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    if cfg.norm_type == "layernorm":
        mean = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        x_hat = (x - mean) * torch.rsqrt(var + cfg.norm_eps)
        out = x_hat * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = x.square().mean(-1, keepdim=True)
        x_hat = x * torch.rsqrt(ms + cfg.norm_eps)
        scale = p["scale"].float()
        if cfg.gemma_norm:
            scale = 1.0 + scale
        out = x_hat * scale
    return out.to(dt)


# ---------------------------------------------------------------------------
# Positions: RoPE (split-half / NeoX convention), M-RoPE, sinusoids
# ---------------------------------------------------------------------------


def rope_freqs(cfg: ModelConfig, rot_dim: int,
               device: torch.device | str) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension (rot_dim/2 pairs)."""
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=device) / rot_dim
    return 1.0 / (cfg.rope_theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
               rot_dim: int | None = None) -> torch.Tensor:
    """x: (batch, seq, heads, head_dim); positions: (batch, seq) int, or
    (3, batch, seq) for M-RoPE (temporal / height / width coordinates)."""
    head_dim = x.shape[-1]
    rot = rot_dim if rot_dim is not None else int(head_dim * cfg.rope_fraction)
    rot = min(rot, head_dim)
    inv_freq = replicate(rope_freqs(cfg, rot, x.device))
    if cfg.pos_type == "mrope":
        sections = cfg.mrope_sections  # in frequency pairs, summing to rot/2
        if positions.ndim != 3 or sum(sections) != rot // 2:
            raise ValueError(f"M-RoPE needs (3, batch, seq) positions and "
                             f"sections summing to {rot // 2}: got "
                             f"{tuple(positions.shape)}, {sections}")
        # each section's pairs take the angle of their own coordinate stream
        starts = np.cumsum((0,) + tuple(sections))
        angle = torch.cat([positions[c].float()[..., None]
                           * inv_freq[starts[c]:starts[c + 1]]
                           for c in range(len(sections))], dim=-1)
    else:
        angle = positions.float()[..., None] * inv_freq  # (b, s, rot/2)
    sin = torch.sin(angle)[..., None, :]  # (b, s, 1, rot/2)
    cos = torch.cos(angle)[..., None, :]
    x1 = x[..., : rot // 2].float()
    x2 = x[..., rot // 2: rot].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    parts = [out1.to(x.dtype), out2.to(x.dtype)]
    if rot < head_dim:
        parts.append(x[..., rot:])
    return torch.cat(parts, dim=-1)


@functools.lru_cache(maxsize=8)
def sinusoidal_positions(seq_len: int, d_model: int,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cpu") -> torch.Tensor:
    """Standard transformer sinusoids (whisper encoder positions): the
    table is built in float64, as ``repro/models/layers.py:139-145`` builds
    it with numpy, and cast to ``dtype`` once.  Cached per arguments, so an
    encoder builds and copies it to the device once, not at every call
    (JAX's jit makes it a constant): callers must not write into it."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * dim / d_model)
    table = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(table).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# MLP (dense / GLU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None,
             *, stack: int = 0, device: torch.device | str = "cuda") -> dict:
    """A GLU or dense MLP of width ``d_ff`` (default ``cfg.d_ff``; MoE's
    shared experts pass ``n_shared_experts * d_ff_expert``)."""
    d, ff, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.param_dtype
    kw = dict(stack=stack, device=device)
    p = {
        "w_up": Param(dense_init(gen, (d, ff), 1, dt, **kw), ("embed_fsdp", "mlp")),
        "w_down": Param(dense_init(gen, (ff, d), 1, dt, **kw),
                        ("mlp", "embed_fsdp")),
    }
    if cfg.mlp_type == "glu":
        p["w_gate"] = Param(dense_init(gen, (d, ff), 1, dt, **kw),
                            ("embed_fsdp", "mlp"))
    return p


def _act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu(approximate=True)
    return F.silu(x)


def apply_mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    cdt = torch_dtype(cfg.compute_dtype)
    h = x @ p["w_up"].to(cdt)
    if cfg.mlp_type == "glu":
        g = x @ p["w_gate"].to(cdt)
        h = _act(cfg, g) * h
    else:
        h = _act(cfg, h)
    return h @ p["w_down"].to(cdt)
