"""Paged decode attention: the wrapper of the hand-written Hopper kernel
``csrc/paged_attention.cu``.  It replaces no Pallas kernel: the JAX package
gathers every slot's pages with XLA and runs plain attention
(``src/repro/kernels/ops.py::paged_attention``), and so does the port on a
CPU tensor (``kernels/ops.py::paged_attention``).

On a CUDA tensor ``paged_attention`` launches the kernel or raises.  The
kernel reads each slot's live pages through the block table, in the pools'
own dtype, and never writes a view; its source carries the note on what
bounds it on the card and what its design does about it.

Its grid is fixed by the shapes alone: every (slot, kv head) is cut into the
same ``page_split`` ranges of pages, a range past the page that holds the
slot's query position exits at once, and with more than one range a second
kernel merges the ranges' partials in range order.  ``launches`` counts
wrapper calls (one or two kernels each).  The plain twin of that split and
merge, ``paged_attention_split_plain``, computes each live range's partial
(max in log2 units, sum, unnormalised output) over its own keys and merges
them with the merge kernel's formula, so the CPU tests hold the algorithm
against the gather path.

The call is capturable in a CUDA graph: no host-to-device copy, no
synchronisation, scratch from ``torch.empty`` by shape, and nothing read
from the device on the host.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

#: kernel launches since the last reset (the plain twin never counts)
launches = 0

SUPPORTED_D = (16, 32, 64, 128, 256)
#: query heads a CTA serves: the largest of these that divides the group
GROUP_CHUNKS = (8, 4, 2, 1)
#: SMs of an H100 SXM
N_SM = 132
#: the split aims at this many CTAs an SM were every page of every table
#: row live (the live share is unknown on the host)
CTAS_PER_SM = 64
#: keys a range holds at the least: a range's partial costs (D + 2) floats
#: written and read again a query head
MIN_RANGE_KEYS = 128
LOG2E = 1.4426950408889634
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = build.load("paged_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.repro_paged_attention_fwd.argtypes = (
            [p] * 8 + [i] * 15 + [f, p])
        lib.repro_paged_attention_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def group_chunk(G: int) -> int:
    """Query heads a CTA serves at group size ``G``."""
    return next(c for c in GROUP_CHUNKS if G % c == 0)


def page_split(B: int, Hkv: int, G: int, max_pages: int,
               page_size: int) -> tuple[int, int]:
    """(pages a range, ranges) of every table row.  Enough ranges that B x
    kv heads x query-head chunks x ranges reaches ``CTAS_PER_SM`` CTAs an
    SM, as few as that takes, and none shorter than ``MIN_RANGE_KEYS``
    keys: granite-moe-1b-a400m's 64 slots x 8 kv heads take 16 ranges of
    16 pages at 256 pages a row, 8 of 8 at 64."""
    units = B * Hkv * (G // group_chunk(G))
    most = max(1, max_pages * page_size // MIN_RANGE_KEYS)
    n = max(1, min(most, -(-CTAS_PER_SM * N_SM // units)))
    pages = -(-max_pages // n)
    return pages, -(-max_pages // pages)


def live_pages(pos_q: int, causal: bool, window: int, page_size: int,
               max_pages: int) -> tuple[int, int]:
    """The pages [first, last] of a table row that hold a key the query at
    ``pos_q`` can see (``live_pages`` in C); last < first for an inactive
    row (pos_q < 0)."""
    if pos_q < 0:
        return 0, -1
    last = min(pos_q // page_size, max_pages - 1) if causal else max_pages - 1
    first = max(0, pos_q - window + 1) // page_size if window > 0 else 0
    return first, last


def paged_attention_split_plain(q: torch.Tensor, kp: torch.Tensor,
                                vp: torch.Tensor, posp: torch.Tensor,
                                table: torch.Tensor, pos_q: torch.Tensor, *,
                                causal: bool = True, window: int = 0,
                                scale: float | None = None) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch, f32: each live range of
    ``page_split`` reads its allocated pages (table entries in [0, n_pages))
    from the slot's first live page to its last, masks by the pool's
    positions as ``models/attention.py::_mask`` does, and yields per query
    head its max m (log2 units, -inf when it saw no key), sum l and
    unnormalised output o; the ranges merge in order: M = max m_r, w_r =
    2^(m_r - M), out = sum w_r o_r / sum w_r l_r, and 0 where l == 0 (an
    inactive row, pos_q < 0, reads nothing).  Rounded once to q's dtype."""
    B, _, Hq, D = q.shape
    n_pages = posp.shape[0] - 1
    ps, Hkv = kp.shape[1], kp.shape[2]
    P = table.shape[1]
    G = Hq // Hkv
    sl2 = (scale if scale is not None else D ** -0.5) * LOG2E
    pages, n_ranges = page_split(B, Hkv, G, P, ps)
    out = torch.zeros((B, Hq, vp.shape[-1]), dtype=torch.float32)
    for b in range(B):
        pq = int(pos_q[b, 0])
        first, last = live_pages(pq, causal, window, ps, P)
        qb = q[b, 0].float().reshape(Hkv, G, D) * sl2
        parts = []
        for r in range(n_ranges):
            p0, p1 = max(first, r * pages), min(last + 1, (r + 1) * pages)
            if p0 >= p1:
                continue
            row = table[b, p0:p1].long()
            row = row[(row >= 0) & (row < n_pages)]
            k = kp[row].reshape(-1, Hkv, D).float()
            v = vp[row].reshape(-1, Hkv, vp.shape[-1]).float()
            pk = posp[row].reshape(-1)
            vis = pk >= 0
            if causal:
                vis &= pk <= pq
            if window > 0:
                vis &= (pq - pk) < window
            s = torch.einsum("hgd,khd->hgk", qb, k)
            s = s.masked_fill(~vis, -math.inf)
            m = s.amax(-1) if s.shape[-1] else torch.full((Hkv, G), -math.inf)
            p = torch.exp2(s - torch.where(m == -math.inf, 0.0, m)[..., None])
            o = torch.einsum("hgk,khd->hgd", p, torch.where(vis[:, None, None],
                                                            v, 0.0))
            parts.append((m, p.sum(-1), o))
        if not parts:
            continue
        ms = torch.stack([m for m, _, _ in parts])
        mmax = ms.amax(0)
        w = torch.where(ms == -math.inf, 0.0,
                        torch.exp2(ms - torch.where(mmax == -math.inf, 0.0,
                                                    mmax)))
        l = sum(wr * lr for wr, (_, lr, _) in zip(w, parts))
        o = sum(wr[..., None] * orr for wr, (_, _, orr) in zip(w, parts))
        out[b] = (o / torch.where(l == 0, 1.0, l)[..., None]).reshape(Hq, -1)
    return out[:, None].to(q.dtype)


def _check(q, kp, vp, posp, table, pos_q):
    if build.any_dtensor(q, kp, vp, posp, table, pos_q):
        raise TypeError("paged_attention takes plain tensors, not DTensors: "
                        "no engine pages under a mesh")
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, Hq, D), got {tuple(q.shape)}")
    B, _, Hq, D = q.shape
    if kp.ndim != 4 or vp.shape != kp.shape or kp.shape[3] != D:
        raise ValueError(f"pools must be (n_pages + 1, page_size, Hkv, {D}), "
                         f"got k {tuple(kp.shape)} v {tuple(vp.shape)}")
    rows, ps, Hkv, _ = kp.shape
    if posp.shape != (rows, ps) or rows < 2:
        raise ValueError(f"pos must be {(rows, ps)} with a trash page, got "
                         f"{tuple(posp.shape)}")
    if table.ndim != 2 or table.shape[0] != B or pos_q.shape != (B, 1):
        raise ValueError(f"table must be (B, max_pages) and pos_q (B, 1), got "
                         f"{tuple(table.shape)} and {tuple(pos_q.shape)}")
    if Hkv == 0 or Hq % Hkv or B == 0 or table.shape[1] == 0:
        raise ValueError(f"bad counts: q {tuple(q.shape)}, k {tuple(kp.shape)}, "
                         f"table {tuple(table.shape)}")
    if D not in SUPPORTED_D:
        raise ValueError(f"head dim D={D} not supported (D in {SUPPORTED_D})")
    if q.dtype not in _DTYPE_CODE or kp.dtype not in _DTYPE_CODE \
            or vp.dtype != kp.dtype:
        raise TypeError(f"q and the pools must be bf16 or f32 (pools alike), "
                        f"got {q.dtype}, {kp.dtype}, {vp.dtype}")
    if posp.dtype != torch.int32:
        raise TypeError(f"pos must be int32, got {posp.dtype}")
    tensors = (q, kp, vp, posp, table, pos_q)
    if any(t.device != q.device for t in tensors):
        raise ValueError("inputs must lie on one device")
    if not (kp.is_contiguous() and vp.is_contiguous() and posp.is_contiguous()):
        raise ValueError("paged_attention takes contiguous pools")
    if build.misaligned((q, kp, vp)):  # the kernel's 16-byte row loads
        raise ValueError("paged_attention needs 16-byte aligned q and pools")


def paged_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                    posp: torch.Tensor, table: torch.Tensor,
                    pos_q: torch.Tensor, *, causal: bool = True,
                    window: int = 0, scale: float | None = None) -> torch.Tensor:
    """q: (B, 1, Hq, D) bf16 or f32; kp, vp: (n_pages + 1, page_size, Hkv,
    D) pools, bf16 or f32, whose last page is the trash page; posp:
    (n_pages + 1, page_size) int32; table: (B, max_pages), entries outside
    [0, n_pages) unallocated; pos_q: (B, 1) -> (B, 1, Hq, D) in q's dtype,
    by the kernel.  A row with pos_q < 0 gives zeros."""
    global launches
    _check(q, kp, vp, posp, table, pos_q)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type != "cuda":
        raise ValueError(f"no paged_attention kernel for device {q.device}: "
                         "kernels/ops.py::paged_attention runs the gather "
                         "path on a CPU tensor")
    B, _, Hq, D = q.shape
    rows, ps, Hkv, _ = kp.shape
    P = table.shape[1]
    G = Hq // Hkv
    gc = group_chunk(G)
    pages, n_ranges = page_split(B, Hkv, G, P, ps)
    scale = scale if scale is not None else D ** -0.5
    q = q.contiguous()
    table = table.to(torch.int32).contiguous()
    pos_q = pos_q.reshape(B).to(torch.int32).contiguous()
    out = torch.empty_like(q)
    scratch = (torch.empty(B * Hq * n_ranges * (D + 2), dtype=torch.float32,
                           device=q.device) if n_ranges > 1 else None)
    shift = ps.bit_length() - 1 if ps & (ps - 1) == 0 else -1

    def launch():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        return _kernel().repro_paged_attention_fwd(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), posp.data_ptr(),
            table.data_ptr(), pos_q.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[kp.dtype], B, Hq, Hkv, D, gc,
            rows - 1, ps, shift, P, pages, n_ranges, int(causal), int(window),
            float(scale), stream)

    if q.device.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(q.device):
            err = launch()
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
