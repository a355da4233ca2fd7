"""Paged KV cache: block-table-backed page pools shared across decode slots.

Port of ``repro.launch.paged_kv``.  Full-attention KV caches are fixed-size
page pools shared by all slots: a request reserves exactly
``ceil((prompt + max_new + 1) / page_size)`` pages at admission and returns
them on completion.

Layout
------
Per full-attention layer the pool leaves are ``k``/``v``:
``(n_pages + 1, page_size, H, D)`` and ``pos``: ``(n_pages + 1, page_size)``
(-1 = empty).  A device-resident block table ``(n_slots, max_pages)`` maps
each slot's logical pages to physical ones; unallocated entries hold
``n_pages``.  JAX drops scatters to that index and fills gathers from it;
here the pool's extra last page is a write-only trash page that absorbs
those scatters, and every gather masks entries >= ``n_pages`` to the fill
value (``utils.take_fill``) -- still no branching and no host read.

Correctness invariants (each guards a real aliasing bug):

* newly allocated pages get their pool ``pos`` reset to -1 before use -- a
  recycled page's stale positions could otherwise unmask another request's
  keys;
* a freed slot's table row is cleared to ``n_pages`` immediately, so decode
  ticks for dead slots write the trash page instead of recycled pages;
* the dense per-slot leaves (SWA rings, cross caches) are reset to their
  ``init_cache`` values at allocation time.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.models import LanguageModel
from repro_torch.utils import Spec, take_fill, to_device, tree_leaves, tree_map


def _pages_dim(spec: Spec) -> int | None:
    return spec.axes.index("pages") if "pages" in spec.axes else None


def _batch_dim(spec: Spec) -> int:
    return spec.axes.index("batch")


@dataclasses.dataclass
class PageStats:
    n_pages: int
    page_size: int
    pages_in_use: int
    pages_free: int
    tokens_reserved: int


class PagedKVCache:
    """Host-side allocator + device-side gather/scatter for the hybrid cache.

    ``max_pages`` bounds one slot's capacity: the dense *view* used during
    chunked prefill is ``max_pages * page_size`` tokens long, and position
    ``p`` of a slot always lives at page ``p // page_size`` of its table row
    -- the gathered view is literally a dense cache, so ``prefill_chunk``
    needs no paged-awareness at all.
    """

    def __init__(self, model: LanguageModel, n_slots: int, n_pages: int,
                 page_size: int, max_pages: int, enc_len: int = 0,
                 dtype=torch.bfloat16):
        self.model = model
        self.device = model.device
        self.n_slots = n_slots
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_pages = max_pages
        self.view_len = max_pages * page_size
        pages = (n_pages, page_size)
        self.specs = model.cache_specs(n_slots, self.view_len,
                                       enc_len=enc_len, dtype=dtype,
                                       pages=pages)
        self.cache = model.init_cache(n_slots, self.view_len, enc_len=enc_len,
                                      dtype=dtype, pages=pages)
        self.table = torch.full((n_slots, max_pages), n_pages,
                                dtype=torch.int32, device=self.device)
        self._free = list(range(n_pages - 1, -1, -1))  # pop() -> page 0 first
        self._slot_pages: list[list[int]] = [[] for _ in range(n_slots)]

    # ------------------------------------------------------------ allocation
    def pages_needed(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.page_size)

    def can_alloc(self, n_tokens: int) -> bool:
        need = self.pages_needed(n_tokens)
        return need <= self.max_pages and need <= len(self._free)

    def alloc(self, slot: int, n_tokens: int) -> bool:
        """Reserve capacity for ``n_tokens`` in ``slot`` and reset its state
        (pool positions of the new pages + the dense per-slot leaves)."""
        if self._slot_pages[slot]:
            raise ValueError(f"slot {slot} already allocated")
        need = self.pages_needed(n_tokens)
        if need > self.max_pages or need > len(self._free):
            return False
        pages = [self._free.pop() for _ in range(need)]
        self._slot_pages[slot] = pages
        row = torch.tensor(pages + [self.n_pages] * (self.max_pages - need),
                           dtype=torch.int32, device=self.device)
        self.table[slot] = row
        self._prepare_impl(self.cache, row, slot)
        return True

    def free(self, slot: int) -> None:
        self._free.extend(reversed(self._slot_pages[slot]))
        self._slot_pages[slot] = []
        self.table[slot] = self.n_pages

    def stats(self) -> PageStats:
        used = sum(len(p) for p in self._slot_pages)
        return PageStats(
            n_pages=self.n_pages, page_size=self.page_size,
            pages_in_use=used, pages_free=len(self._free),
            tokens_reserved=used * self.page_size)

    # ------------------------------------------------- device gather/scatter
    def view_bytes(self, G: int) -> int:
        """Bytes of a G-slot view (``_gather_impl``'s tree), from the specs:
        a pool leaf's (pages, page_size) become (G, view_len), a dense
        leaf's slots become G."""
        def leaf(spec: Spec) -> int:
            shape = list(spec.shape)
            pdim = _pages_dim(spec)
            if pdim is None:
                shape[_batch_dim(spec)] = G
            else:
                shape[pdim:pdim + 2] = [G, self.view_len]
            return math.prod(shape) * spec.dtype.itemsize

        return sum(leaf(spec) for spec in tree_leaves(self.specs))

    def gather_slot(self, slot: int) -> dict:
        """Dense (B=1, view_len, ...) cache view of one slot -- the exact tree
        ``init_cache(1, view_len, enc_len)`` would produce, for
        ``prefill_chunk``."""
        return self._gather_impl(self.cache, self.table[slot][None], [slot])

    def scatter_slot(self, slot: int, view: dict) -> None:
        self._scatter_impl(self.cache, view, self.table[slot][None], [slot])

    def _gather_impl(self, cache: dict, rows: torch.Tensor,
                     slots: list[int]) -> dict:
        """Dense (G, view_len, ...) view of G slots at once (``rows``:
        ``(G, max_pages)`` on the device, ``slots``: G host ints).  Padded
        group members use ``slots == n_slots`` / ``rows == n_pages``: their
        view fills with init values and ``_scatter_impl`` drops it, so a
        fixed group size keeps every chunk call the same shape."""
        G = len(slots)
        slot_idx = to_device(slots, torch.long, self.device)
        flat = rows.reshape(-1)

        def g(leaf: torch.Tensor, spec: Spec) -> torch.Tensor:
            fill = -1 if leaf.dtype == torch.int32 else 0
            pdim = _pages_dim(spec)
            if pdim is None:
                return take_fill(leaf, slot_idx, _batch_dim(spec), fill)
            v = take_fill(leaf, flat, pdim, fill, bound=self.n_pages)
            return v.reshape(v.shape[:pdim] + (G, self.view_len)
                             + v.shape[pdim + 2:])

        return tree_map(g, cache, self.specs)

    def _scatter_impl(self, cache: dict, view: dict, rows: torch.Tensor,
                      slots: list[int]) -> None:
        """Write a ``_gather_impl`` view back, in place.  Pool leaves write
        every page of the view; unallocated entries (== n_pages, including
        all of a padded member's row) land on the trash page.  Dense leaves
        write the real members only (``slots < n_slots``)."""
        G = len(slots)
        real = [i for i, s in enumerate(slots) if s < self.n_slots]
        src = to_device(real, torch.long, self.device)
        dst = to_device([slots[i] for i in real], torch.long, self.device)
        flat = rows.reshape(-1).long()

        def s(leaf: torch.Tensor, v: torch.Tensor, spec: Spec) -> None:
            pdim = _pages_dim(spec)
            if pdim is None:
                bdim = _batch_dim(spec)
                leaf.index_copy_(bdim, dst,
                                 v.index_select(bdim, src).to(leaf.dtype))
                return
            v = v.reshape(v.shape[:pdim] + (G * self.max_pages, self.page_size)
                          + v.shape[pdim + 2:])
            leaf.index_copy_(pdim, flat, v.to(leaf.dtype))

        tree_map(s, cache, view, self.specs)

    def _prepare_impl(self, cache: dict, row: torch.Tensor, slot: int) -> None:
        """Allocation-time reset: pool ``pos`` of the new pages -> -1 (kills
        stale positions on recycled pages) and the slot's dense leaves back
        to their init values."""
        def r(leaf: torch.Tensor, spec: Spec) -> None:
            pdim = _pages_dim(spec)
            if pdim is not None:
                if leaf.dtype == torch.int32:  # k/v garbage is masked by pos
                    leaf.index_fill_(pdim, row.long(), -1)
                return
            fill = -1 if leaf.dtype == torch.int32 else 0
            leaf.select(_batch_dim(spec), slot).fill_(fill)

        tree_map(r, cache, self.specs)


@functools.cache
def chunk_ladder(chunk_max: int) -> tuple[int, ...]:
    """Power-of-two chunk sizes {chunk_max, ..., 4, 2, 1} -- every prompt
    length decomposes exactly (greedy largest-first), so chunked prefill
    needs zero padding."""
    if chunk_max < 1 or chunk_max & (chunk_max - 1):
        raise ValueError(f"chunk_max must be a power of two, got {chunk_max}")
    out = []
    c = chunk_max
    while c >= 1:
        out.append(c)
        c //= 2
    return tuple(out)


def decompose(n: int, chunk_max: int) -> list[int]:
    """Exact chunk decomposition of ``n`` tokens, largest chunks first."""
    out = []
    for c in chunk_ladder(chunk_max):
        while n >= c:
            out.append(c)
            n -= c
    return out
