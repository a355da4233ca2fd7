"""Serving engines: paged high-throughput engine + dense reference batcher.

Port of ``repro.launch.serve``.  Two implementations share the ``Request``
interface:

``PagedServingEngine`` (the production path)
    Block-table-backed paged KV cache (``launch/paged_kv.py``), chunked
    prefill on a power-of-two ladder interleaved with decode ticks, batched
    same-size prefill groups, and device-resident decode: a block of
    ``drain_every`` ticks is a Python loop of device calls with on-device
    argmax and an on-device token ring, and the host reads the device only
    in ``_drain``, once per block.  Completion is count-based, so the host
    schedules without reading the device between drains.  On a card the
    block is one CUDA graph (``_tick_block``), and the prefill rounds move
    their host data without a stream sync (``utils.to_device``), so the
    host prepares the next rounds while the card decodes.

``ContinuousBatcher`` (the dense reference)
    Lockstep batcher over dense ``(n_slots, max_len)`` caches with full,
    unchunked ``prefill`` at admission -- the path that runs the flash
    kernel (attention) or the WKV scan kernel (RWKV-6) -- and one host read
    per tick.  The paged engine's chunked prefill runs the WKV scan kernel
    too, once per rwkv layer per prefill round, and its decode ticks the
    paged-attention kernel, once per attention layer per tick.

Both report ``host_syncs`` and device<->host byte counters in their stats.
The paged engine also returns its span record (``stats["spans"]``): the
host's time in each of its phases on ``time.time_ns`` -- the clock the
profiler stamps device events on -- and, on a card, the device time of a
prefill round's KV view and model and of each decode block, between CUDA
events read at the drains.  It adds no synchronisation and no profiler
annotation.

Neither engine passes encoder frames, as in JAX (whose ``_Prefilling``
carries ``frames=None`` and whose batcher prefills tokens only): an
encoder-decoder model (whisper) fails in its first prefill with the
model's error naming ``batch["frames"]``, and is driven through
``LanguageModel.prefill`` with ``frames`` and ``decode_step`` instead.
``enc_len`` sizes the cross caches all the same, as in JAX.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import importlib
import time

import numpy as np
import torch

from repro_torch.configs import list_configs
from repro_torch.kernels import paged_attention as _pa
from repro_torch.launch.paged_kv import PagedKVCache, decompose
from repro_torch.models import LanguageModel
from repro_torch.utils import Spec, sync, take_fill, to_device, tree_map


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    arrival: int = 0  # earliest admit tick (0 = already queued)
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False
    admit_tick: int = -1
    finish_tick: int = -1


# ---------------------------------------------------------------------------
# Span record
# ---------------------------------------------------------------------------


@dataclasses.dataclass(slots=True)
class Span:
    """One phase of a run on the host's clock (``time.time_ns``); the run's
    spans nest by ``parent`` (an ``id``, or None at the top).  ``device_ms``
    is the time the device took between two CUDA events recorded on the
    working stream at the phase's edges, where the engine times it."""
    name: str
    id: int
    parent: int | None
    start_ns: int
    end_ns: int = 0
    device_ms: float | None = None


class SpanRecord:
    """The spans of one ``run``, kept in memory.  With ``device`` (a card),
    ``mark`` records a CUDA event on the device's current stream and
    ``interval`` pairs two with a span; ``resolve``, called after a
    synchronisation that follows them, reads their elapsed times, so the
    device is never waited for on the record's account.  Resolved events
    are recorded again."""

    def __init__(self, device: torch.device | None = None):
        self.spans: list[Span] = []
        self._open: list[int] = []
        self._device = device
        self._timed: list[tuple[Span, torch.cuda.Event, torch.cuda.Event]] = []
        self._recorded: list[torch.cuda.Event] = []
        self._free: list[torch.cuda.Event] = []

    @contextlib.contextmanager
    def span(self, name: str):
        s = Span(name, len(self.spans), self._open[-1] if self._open else None,
                 time.time_ns())
        self.spans.append(s)
        self._open.append(s.id)
        try:
            yield s
        finally:
            self._open.pop()
            s.end_ns = time.time_ns()

    def mark(self) -> torch.cuda.Event | None:
        if self._device is None:
            return None
        ev = (self._free.pop() if self._free
              else torch.cuda.Event(enable_timing=True))
        ev.record(torch.cuda.current_stream(self._device))
        self._recorded.append(ev)
        return ev

    def interval(self, span: Span, start, end) -> None:
        if start is not None:
            self._timed.append((span, start, end))

    def resolve(self) -> None:
        for span, start, end in self._timed:
            span.device_ms = start.elapsed_time(end)
        self._timed.clear()
        self._free += self._recorded
        self._recorded.clear()


# ---------------------------------------------------------------------------
# Paged serving engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Prefilling:
    req: Request
    start: int  # next prompt position to compute


class PagedServingEngine:
    """Many concurrent streams over a shared paged KV pool.

    Per engine iteration: one device-resident block of ``drain_every``
    batched decode ticks (inactive slots carry ``pos == -1`` and change
    nothing), then up to ``prefill_chunks_per_tick`` prefill chunks for
    admitted-but-not-yet-decoding requests.  Output tokens accumulate in a
    device ring and drain to the host once per block; freed slots are
    recycled at drain boundaries.

    Each ``run`` keeps a ``SpanRecord``: ``run``; ``admit``;
    ``decode.block`` (the ``_tick_block`` call); ``prefill.round`` with
    ``prefill.prepare``, ``kv.gather``, ``model.prefill_chunk``,
    ``kv.scatter`` and ``prefill.finalize``; ``drain`` with ``drain.wait``
    (the synchronisation and the ring's read) and ``drain.unpack``.  On a
    card the KV view's gather and scatter, the model and the decode block
    carry their device time.
    """

    def __init__(self, model: LanguageModel, params: dict, n_slots: int = 64,
                 max_len: int = 256, page_size: int = 16,
                 pool_fraction: float = 1.0, chunk_max: int = 64,
                 drain_every: int = 8, prefill_chunks_per_tick: int = 1,
                 prefill_group: int = 8, enc_len: int = 0,
                 dtype=torch.bfloat16):
        self.model = model
        self.params = model.cast_for_compute(params)
        self.device = model.device
        self.n_slots = n_slots
        self.chunk_max = chunk_max
        self.drain_every = drain_every
        self.prefill_chunks_per_tick = prefill_chunks_per_tick
        self.prefill_group = prefill_group
        max_pages = -(-max_len // page_size)
        n_pages = max(1, int(n_slots * max_pages * pool_fraction))
        self.kv = PagedKVCache(model, n_slots, n_pages, page_size, max_pages,
                               enc_len=enc_len, dtype=dtype)

        B, dev, i32 = n_slots, self.device, torch.int32
        self.last_token = torch.zeros((B,), dtype=i32, device=dev)
        self.pos = torch.full((B,), -1, dtype=i32, device=dev)
        self.remaining = torch.zeros((B,), dtype=i32, device=dev)
        self.out_buf = torch.zeros((B, drain_every), dtype=i32, device=dev)
        self.out_cnt = torch.zeros((B,), dtype=i32, device=dev)
        self._rows = torch.arange(B, device=dev)
        # the decode block as a CUDA graph: warmed on its own stream by the
        # first block, captured on it by the second (_tick_block)
        self._graph: torch.cuda.CUDAGraph | None = None
        self._graph_stream = None
        self._graph_launches = 0  # paged-attention launches the graph holds

        # host mirrors (decode emission is deterministic: one token per
        # active slot per tick, so no device reads are needed to schedule)
        self.slot_req: list[Request | None] = [None] * B
        self._active: set[int] = set()        # emitting slots
        self._finished: set[int] = set()      # done, tokens pending drain
        self._pf: collections.OrderedDict[int, _Prefilling] = \
            collections.OrderedDict()
        self._remaining_h = np.zeros((B,), np.int64)

        self.stats_counters = {
            "host_syncs": 0, "bytes_to_host": 0, "bytes_to_device": 0,
            "drains": 0, "prefill_rounds": 0, "prefill_chunks": 0,
            "decode_ticks": 0, "stall_ticks": 0, "kv_view_bytes": 0,
            "paged_attention_launches": 0,
        }
        # what a round's gather and scatter read and write: the view's
        # source read and the view written, then the view read and written
        # back, each byte once
        self._round_view_bytes = 4 * self.kv.view_bytes(prefill_group)
        self._spans = SpanRecord()

    # ------------------------------------------------------- device programs
    def _tick_block(self) -> None:
        """``drain_every`` decode ticks with no host read.  On a card the
        block runs as one CUDA graph: the first block runs eagerly on the
        graph's stream (cuBLAS and the allocator warm up), the second is
        captured there and replayed, and every later block replays it.  A
        replay launches the captured kernels on the same tensors -- the
        weights, the cache pools, the block table and the slot state, all
        updated in place -- without the host's ~2,000 launches a tick,
        which held a 64-slot tick to a 4-slot one's wall (ROADMAP fault
        6).  Each attention layer of a tick launches the paged-attention
        kernel (``kernels/paged_attention.py``), whose Python counter moves
        only while the block runs eagerly or is captured: the engine keeps
        the launches its captured block holds and adds them at every
        replay, as ``stats["paged_attention_launches"]``."""
        if self.device.type != "cuda":
            self._decode_ticks()
            return
        before = _pa.launches
        if self._graph is None:
            if self._graph_stream is None:  # first block: eager, warming
                self._graph_stream = torch.cuda.Stream(self.device)
                self._graph_stream.wait_stream(
                    torch.cuda.current_stream(self.device))
                with torch.cuda.stream(self._graph_stream):
                    self._decode_ticks()
                torch.cuda.current_stream(self.device).wait_stream(
                    self._graph_stream)
                self.stats_counters["paged_attention_launches"] += (
                    _pa.launches - before)
                return
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self._graph_stream):
                self._decode_ticks()
            self._graph = graph
            self._graph_launches = _pa.launches - before
        self._graph.replay()
        self.stats_counters["paged_attention_launches"] += self._graph_launches

    def _decode_ticks(self) -> None:
        """The block's device work: argmax, the token ring and the per-slot
        counters stay on the device, each written in place."""
        b = self._rows
        last, pos, remaining = self.last_token, self.pos, self.remaining
        out_buf, out_cnt = self.out_buf, self.out_cnt
        for _ in range(self.drain_every):
            emit = remaining > 0
            pos_eff = torch.where(emit, pos, -1)
            logits, _ = self.model.decode_step(self.params, last[:, None],
                                               self.kv.cache, pos_eff,
                                               table=self.kv.table)
            nxt = torch.argmax(logits, -1).to(torch.int32)
            # emit the *input* token (the first emitted token is the
            # post-prefill argmax).  JAX sends inactive columns out of
            # bounds; here an inactive row rewrites its own column 0.
            col = torch.where(emit, out_cnt, 0).long()
            out_buf[b, col] = torch.where(emit, last, out_buf[b, col])
            inc = emit.to(torch.int32)
            last.copy_(torch.where(emit, nxt, last))
            pos.add_(inc)
            remaining.sub_(inc)
            out_cnt.add_(inc)

    def _chunk(self, slots: list[int], tokens: torch.Tensor,
               start: torch.Tensor) -> torch.Tensor:
        """One batched prefill round: G slots advance one chunk each.
        Padded group entries (slot == n_slots, start == -1) gather init
        values, compute garbage, and are never written back."""
        kv, rec = self.kv, self._spans
        with rec.span("kv.gather") as gather:
            e0 = rec.mark()
            slot_idx = to_device(slots, torch.long, self.device)
            rows = take_fill(kv.table, slot_idx, 0, kv.n_pages)
            view = kv._gather_impl(kv.cache, rows, slots)
            e1 = rec.mark()
        with rec.span("model.prefill_chunk") as model:
            logits, view = self.model.prefill_chunk(
                self.params, {"tokens": tokens}, view, start)
            e2 = rec.mark()
        with rec.span("kv.scatter") as scatter:
            kv._scatter_impl(kv.cache, view, rows, slots)
            e3 = rec.mark()
        rec.interval(gather, e0, e1)
        rec.interval(model, e1, e2)
        rec.interval(scatter, e2, e3)
        return logits

    def _finalize(self, logits: torch.Tensor, slot: int, plen: int,
                  max_new: int) -> None:
        self.last_token[slot] = torch.argmax(logits).to(torch.int32)
        self.pos[slot] = plen
        self.remaining[slot] = max_new

    # ----------------------------------------------------------- scheduling
    def _admit(self, queue: collections.deque, now: int) -> None:
        """Scan the whole queue (no head-of-line blocking): any request whose
        page reservation fits an open slot is admitted; over-sized requests
        are rejected outright instead of wedging the queue."""
        free_slots = [s for s in range(self.n_slots)
                      if self.slot_req[s] is None]
        if not free_slots:
            return
        keep: list[Request] = []
        while queue:
            req = queue.popleft()
            need = len(req.prompt) + req.max_new + 1
            if self.kv.pages_needed(need) > self.kv.max_pages:
                req.rejected = True
                req.done = True
                continue
            if free_slots and self.kv.can_alloc(need):
                slot = free_slots.pop(0)
                self.kv.alloc(slot, need)
                self.slot_req[slot] = req
                req.admit_tick = now
                self._pf[slot] = _Prefilling(req=req, start=0)
            else:
                keep.append(req)
        queue.extend(keep)

    def _prefill_step(self) -> None:
        """One batched prefill round: the oldest prefilling request picks the
        chunk size, every other pending request at the same size joins the
        group (up to ``prefill_group``), one call advances them all."""
        if not self._pf:
            return
        rec = self._spans
        with rec.span("prefill.round"):
            with rec.span("prefill.prepare"):
                c, members, slots, tokens, starts = self._prepare_round()
            logits = self._chunk(slots, tokens, starts)
            self.stats_counters["prefill_rounds"] += 1
            self.stats_counters["prefill_chunks"] += len(members)
            self.stats_counters["kv_view_bytes"] += self._round_view_bytes
            with rec.span("prefill.finalize"):
                self._finish_round(logits, c, members)

    def _prepare_round(self):
        """The round's chunk size, members, slots (padded to the group) and
        its tokens and start positions on the device."""
        _, oldest = next(iter(self._pf.items()))
        c = decompose(len(oldest.req.prompt) - oldest.start, self.chunk_max)[0]
        members = [
            (slot, st) for slot, st in self._pf.items()
            if decompose(len(st.req.prompt) - st.start, self.chunk_max)[0] == c
        ][:self.prefill_group]

        G = self.prefill_group
        tokens = np.zeros((G, c), np.int32)
        starts = np.full((G,), -1, np.int32)
        slots = [self.n_slots] * G  # padding -> never written back
        for i, (slot, st) in enumerate(members):
            tokens[i] = st.req.prompt[st.start:st.start + c]
            starts[i] = st.start
            slots[i] = slot
        self.stats_counters["bytes_to_device"] += int(tokens.nbytes)
        return (c, members, slots, to_device(tokens, torch.int32, self.device),
                to_device(starts, torch.int32, self.device))

    def _finish_round(self, logits: torch.Tensor, c: int,
                      members: list) -> None:
        """Advance the members by ``c``; a finished prompt starts decoding."""
        for i, (slot, st) in enumerate(members):
            st.start += c
            if st.start >= len(st.req.prompt):
                del self._pf[slot]
                self._finalize(logits[i], slot, len(st.req.prompt),
                               st.req.max_new)
                self._active.add(slot)
                self._remaining_h[slot] = st.req.max_new

    def _drain(self, now: int) -> None:
        """Flush the device (the block and the rounds queued behind it),
        read the token ring, then hand each slot its tokens and free the
        finished ones."""
        rec = self._spans
        with rec.span("drain.wait"):
            sync(self.device)
            host = torch.cat([self.out_buf, self.out_cnt[:, None]],
                             1).cpu().numpy()
        with rec.span("drain.unpack"):
            rec.resolve()  # every event recorded so far has completed
            out_buf, out_cnt = host[:, :-1], host[:, -1]
            self.stats_counters["host_syncs"] += 1
            self.stats_counters["bytes_to_host"] += (
                self.out_buf.nbytes + self.out_cnt.nbytes)
            self.stats_counters["drains"] += 1
            for slot in list(self._active | self._finished):
                req = self.slot_req[slot]
                req.out.extend(int(t) for t in out_buf[slot, :out_cnt[slot]])
                if slot in self._finished or len(req.out) >= req.max_new:
                    req.done = True
                    if req.finish_tick < 0:
                        req.finish_tick = now
                    self.slot_req[slot] = None
                    self.kv.free(slot)
                    self._active.discard(slot)
                    self._finished.discard(slot)
            self.out_cnt.zero_()

    # ------------------------------------------------------------------ run
    def run(self, requests: list[Request]) -> dict:
        # re-entrant: a warm engine can serve successive traces
        self.stats_counters = dict.fromkeys(self.stats_counters, 0)
        rec = self._spans = SpanRecord(
            self.device if self.device.type == "cuda" else None)
        pending = collections.deque(sorted(requests, key=lambda r: r.arrival))
        queue: collections.deque[Request] = collections.deque()
        t0 = time.time()
        with rec.span("run"):
            ticks = self._loop(pending, queue)
        wall = time.time() - t0
        served = [r for r in requests if not r.rejected]
        toks = sum(len(r.out) for r in served)
        per_tick = sorted(w / self.drain_every
                          for w in _block_windows_ns(rec.spans))
        stats = {
            "engine": "paged",
            "requests": len(requests),
            "rejected": sum(r.rejected for r in requests),
            "tokens": toks,
            "ticks": ticks,
            "wall_s": wall,
            "tok_per_s": toks / max(wall, 1e-9),
            "tick_ms_p50": _pct(per_tick, 0.50) / 1e6,
            "tick_ms_p99": _pct(per_tick, 0.99) / 1e6,
            "prefill_stall_fraction": (
                self.stats_counters["stall_ticks"]
                / max(ticks + self.stats_counters["stall_ticks"], 1)),
        }
        stats.update(self.stats_counters)
        stats["spans"] = rec.spans
        return stats

    def _loop(self, pending: collections.deque,
              queue: collections.deque) -> int:
        """Serve until every request is done; the ticks it took."""
        rec = self._spans
        ticks = 0
        ran_block = False
        K = self.drain_every
        while (pending or queue or self._active or self._finished
               or self._pf):
            with rec.span("admit"):
                while pending and pending[0].arrival <= ticks:
                    queue.append(pending.popleft())
                self._admit(queue, ticks)

            if self._active:
                # one device-resident block: K decode ticks, zero host reads
                with rec.span("decode.block") as block:
                    start = rec.mark()
                    self._tick_block()
                    rec.interval(block, start, rec.mark())
                self.stats_counters["decode_ticks"] += K
                ran_block = True
                for slot in list(self._active):
                    left = self._remaining_h[slot]
                    if left <= K:
                        self._active.discard(slot)
                        self._finished.add(slot)
                        self.slot_req[slot].finish_tick = ticks + int(left)
                        self._remaining_h[slot] = 0
                    else:
                        self._remaining_h[slot] = left - K
                ticks += K
            elif self._pf:
                self.stats_counters["stall_ticks"] += 1
            elif pending and not queue:
                ticks = max(ticks, pending[0].arrival)  # idle until arrival

            # prefill backpressure: flood chunks while decode is
            # under-saturated, trickle one round per block once half the
            # slots are streaming
            rounds = (self.prefill_chunks_per_tick
                      if len(self._active) < self.n_slots // 2 else 1)
            for _ in range(rounds):
                self._prefill_step()

            idle = not self._active and not self._pf
            if ran_block or (idle and self._finished):
                with rec.span("drain"):
                    self._drain(ticks)
                ran_block = False
            elif (queue and not self._active and not self._pf
                  and not self._finished):
                # pages exhausted by queued work that can never fit together
                req = queue.popleft()
                req.rejected = True
                req.done = True
        return ticks


def _block_windows_ns(spans: list[Span]) -> list[int]:
    """Each decode block's window: from its dispatch (the ``decode.block``
    span's start) to the end of the drain's wait after it, which flushes
    the block and the prefill rounds queued behind it; so ``tick_ms``
    holds interleaved prefill work but not admission."""
    out, start = [], None
    for s in spans:
        if s.name == "decode.block":
            start = s.start_ns
        elif s.name == "drain.wait" and start is not None:
            out.append(s.end_ns - start)
            start = None
    return out


def _pct(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return float(sorted_vals[i])


# ---------------------------------------------------------------------------
# Dense reference batcher
# ---------------------------------------------------------------------------


class ContinuousBatcher:
    def __init__(self, model: LanguageModel, params: dict, n_slots: int = 4,
                 max_len: int = 256, enc_len: int = 8):
        self.model = model
        self.params = model.cast_for_compute(params)
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.enc_len = enc_len
        self.cache = model.init_cache(n_slots, max_len, enc_len)
        self._slot_specs = model.cache_specs(1, max_len, enc_len)
        self.pos = np.zeros((n_slots,), np.int32)
        self.slot_req: list[Request | None] = [None] * n_slots
        self.last_token = np.zeros((n_slots,), np.int32)
        self.stats_counters = {"host_syncs": 0, "bytes_to_host": 0,
                               "bytes_to_device": 0}

    def _write_slot(self, single: dict, slot: int) -> None:
        """Copy a freshly prefilled B=1 cache into slot ``slot`` of the
        batched cache, in place (the batch dim of every leaf comes from the
        cache spec's axes; scanned segments carry a leading layers dim)."""
        def write(b: torch.Tensor, s_: torch.Tensor, spec: Spec) -> None:
            bdim = spec.axes.index("batch")
            b.select(bdim, slot).copy_(s_.select(bdim, 0))

        tree_map(write, self.cache, single, self._slot_specs)

    def admit(self, req: Request) -> bool:
        if len(req.prompt) + req.max_new + 1 > self.max_len:
            req.rejected = True
            req.done = True
            return True  # consumed (dropped), don't block the queue
        for s in range(self.n_slots):
            if self.slot_req[s] is None:
                self.slot_req[s] = req
                # full prefill into a B=1 cache (flash kernel), then copy
                # the slot in
                cache1 = self.model.init_cache(1, self.max_len, self.enc_len)
                tokens = torch.tensor([req.prompt], dtype=torch.int32,
                                      device=self.device)
                self.stats_counters["bytes_to_device"] += tokens.nbytes
                logits, cache1 = self.model.prefill(self.params,
                                                    {"tokens": tokens}, cache1)
                self._write_slot(cache1, s)
                self.pos[s] = len(req.prompt)
                first = torch.argmax(logits[0]).cpu()  # greedy on the device
                self.stats_counters["host_syncs"] += 1
                self.stats_counters["bytes_to_host"] += first.nbytes
                self.last_token[s] = int(first)
                return True
        return False

    def step(self) -> None:
        active = [s for s in range(self.n_slots) if self.slot_req[s]]
        if not active:
            return
        t = self.last_token.reshape(-1, 1).astype(np.int32)
        logits, self.cache = self.model.decode_step(
            self.params, torch.from_numpy(t).to(self.device), self.cache,
            torch.from_numpy(self.pos).to(self.device))
        self.stats_counters["bytes_to_device"] += t.nbytes + self.pos.nbytes
        nxt = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
        self.stats_counters["host_syncs"] += 1
        self.stats_counters["bytes_to_host"] += int(nxt.nbytes)
        for s in active:
            req = self.slot_req[s]
            req.out.append(int(t[s, 0]))
            self.pos[s] += 1
            self.last_token[s] = nxt[s]
            if (len(req.out) >= req.max_new
                    or self.pos[s] >= self.max_len - 1):
                req.done = True
                self.slot_req[s] = None

    def run(self, requests: list[Request]) -> dict:
        self.stats_counters = dict.fromkeys(self.stats_counters, 0)
        queue = collections.deque(requests)
        t0 = time.time()
        ticks = 0
        while queue or any(self.slot_req):
            # scan past non-admissible heads: a full pool stops the scan
            # (admit can only fail on capacity), but oversized requests are
            # consumed as rejected instead of wedging the queue forever
            n = len(queue)
            for _ in range(n):
                req = queue.popleft()
                if not self.admit(req):
                    queue.appendleft(req)
                    break
            self.step()
            ticks += 1
        wall = time.time() - t0
        served = [r for r in requests if not r.rejected]
        toks = sum(len(r.out) for r in served)
        stats = {"engine": "dense", "requests": len(requests),
                 "rejected": sum(r.rejected for r in requests),
                 "tokens": toks, "ticks": ticks, "wall_s": wall,
                 "tok_per_s": toks / max(wall, 1e-9)}
        stats.update(self.stats_counters)
        return stats


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma-2b", choices=list_configs())
    ap.add_argument("--engine", choices=("paged", "dense"), default="paged")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--drain-every", type=int, default=8)
    ap.add_argument("--enc-len", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    mod = importlib.import_module(
        "repro_torch.configs." + args.arch.replace("-", "_").replace(".", "_"))
    cfg = mod.smoke()
    model = LanguageModel(cfg, device=args.device)
    params = model.init(0)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i,
                    prompt=rng.randint(0, cfg.vocab_size, 8).tolist(),
                    max_new=args.max_new)
            for i in range(args.requests)]
    if args.engine == "paged":
        eng = PagedServingEngine(model, params, n_slots=args.slots,
                                 max_len=args.max_len,
                                 page_size=args.page_size,
                                 drain_every=args.drain_every,
                                 enc_len=args.enc_len)
        stats = eng.run(reqs)
    else:
        batcher = ContinuousBatcher(model, params, n_slots=args.slots,
                                    max_len=args.max_len,
                                    enc_len=args.enc_len)
        stats = batcher.run(reqs)
    stats.pop("spans", None)
    print(f"[serve {args.arch}] {stats}")


if __name__ == "__main__":
    main()
