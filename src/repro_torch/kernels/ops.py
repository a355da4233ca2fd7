"""Dispatch for the port's kernels.

``flash_attention`` is the hand-written Hopper kernel's wrapper
(``kernels/flash_attention.py``): 64-row q tiles against 64-key tiles, on
the wgmma body for bf16 head dims that are multiples of 64 (with the
split-KV plan for short prompts), the mma.sync body for other bf16 head
dims and the FMA body for f32; a shape-keyed tuner for it is later work.
``linear_scan`` is the RWKV-6 WKV scan kernel's wrapper
(``kernels/linear_scan.py``): on a CUDA tensor it runs the chunked body
(64-step chunks as 3xTF32 tensor-core products, three launches) at every
shape, and the per-step body only when a caller asks for it with
``_body="step"``; a failed launch raises, nothing falls back.  ``paged_attention`` is a gather plus
the plain ``attention_core``, as in the JAX package -- not a kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.linear_scan import linear_scan  # noqa: F401
from repro_torch.utils import take_fill


def paged_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                    posp: torch.Tensor, table: torch.Tensor,
                    pos_q: torch.Tensor, *, causal: bool = True,
                    window: int = 0, scale: float | None = None) -> torch.Tensor:
    """Decode attention over a paged KV pool.

    q: (B, 1, Hq, Dk); kp/vp: (n_pages + 1, page_size, Hkv, D) pools whose
    last page is the write-only trash page (``paged_kv_cache_specs``);
    posp: (n_pages + 1, page_size) absolute positions (-1 = empty);
    table: (B, max_pages) block table, entries == n_pages = unallocated.

    Gathers each slot's pages into a contiguous (B, max_pages * page_size)
    view; unallocated entries read k = v = 0 and pos = -1 (``take_fill``), so
    the position mask in ``attention_core`` drops them exactly.
    """
    from repro_torch.models.attention import attention_core  # import cycle

    n_pages = posp.shape[0] - 1
    B, P = table.shape
    ps = kp.shape[1]
    flat = table.reshape(-1)
    k = take_fill(kp, flat, 0, 0, bound=n_pages).reshape(B, P * ps, *kp.shape[2:])
    v = take_fill(vp, flat, 0, 0, bound=n_pages).reshape(B, P * ps, *vp.shape[2:])
    pos_k = take_fill(posp, flat, 0, -1, bound=n_pages).reshape(B, P * ps)
    return attention_core(q, k, v, pos_q, pos_k, causal=causal, window=window,
                          scale=scale)
