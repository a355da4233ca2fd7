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
    schedules without reading the device between drains.

``ContinuousBatcher`` (the dense reference)
    Lockstep batcher over dense ``(n_slots, max_len)`` caches with full,
    unchunked ``prefill`` at admission -- the path that runs the flash
    kernel (attention) or the WKV scan kernel (RWKV-6) -- and one host read
    per tick.  The paged engine's chunked prefill runs the WKV scan kernel
    too, once per rwkv layer per prefill round.

Both report ``host_syncs`` and device<->host byte counters in their stats.

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
import dataclasses
import importlib
import time

import numpy as np
import torch

from repro_torch.configs import list_configs
from repro_torch.launch.paged_kv import PagedKVCache, decompose
from repro_torch.models import LanguageModel
from repro_torch.utils import Spec, sync, take_fill, tree_map


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
            "decode_ticks": 0, "stall_ticks": 0,
        }
        self._window_walls: list[tuple[float, int]] = []  # (wall_s, ticks)

    # ------------------------------------------------------- device programs
    def _tick_block(self) -> None:
        """``drain_every`` decode ticks with no host read: argmax, the token
        ring and the per-slot counters all stay on the device."""
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
            last = torch.where(emit, nxt, last)
            pos = pos + inc
            remaining = remaining - inc
            out_cnt = out_cnt + inc
        self.last_token, self.pos, self.remaining = last, pos, remaining
        self.out_cnt = out_cnt

    def _chunk(self, slots: list[int], tokens: torch.Tensor,
               start: torch.Tensor) -> torch.Tensor:
        """One batched prefill round: G slots advance one chunk each.
        Padded group entries (slot == n_slots, start == -1) gather init
        values, compute garbage, and are never written back."""
        kv = self.kv
        slot_idx = torch.tensor(slots, dtype=torch.long, device=self.device)
        rows = take_fill(kv.table, slot_idx, 0, kv.n_pages)
        view = kv._gather_impl(kv.cache, rows, slots)
        logits, view = self.model.prefill_chunk(self.params, {"tokens": tokens},
                                                view, start)
        kv._scatter_impl(kv.cache, view, rows, slots)
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
        logits = self._chunk(slots, torch.from_numpy(tokens).to(self.device),
                             torch.from_numpy(starts).to(self.device))
        self.stats_counters["prefill_rounds"] += 1
        self.stats_counters["prefill_chunks"] += len(members)
        for i, (slot, st) in enumerate(members):
            st.start += c
            if st.start >= len(st.req.prompt):
                del self._pf[slot]
                self._finalize(logits[i], slot, len(st.req.prompt),
                               st.req.max_new)
                self._active.add(slot)
                self._remaining_h[slot] = st.req.max_new

    def _drain(self, now: int) -> None:
        host = torch.cat([self.out_buf, self.out_cnt[:, None]], 1).cpu().numpy()
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
        self.out_cnt = torch.zeros_like(self.out_cnt)

    # ------------------------------------------------------------------ run
    def run(self, requests: list[Request]) -> dict:
        # re-entrant: a warm engine can serve successive traces
        self.stats_counters = dict.fromkeys(self.stats_counters, 0)
        self._window_walls = []
        pending = collections.deque(sorted(requests, key=lambda r: r.arrival))
        queue: collections.deque[Request] = collections.deque()
        t0 = time.time()
        ticks = 0
        ran_block = False
        window_t0 = t0
        K = self.drain_every
        while (pending or queue or self._active or self._finished
               or self._pf):
            while pending and pending[0].arrival <= ticks:
                queue.append(pending.popleft())
            self._admit(queue, ticks)

            if self._active:
                # one device-resident block: K decode ticks, zero host reads
                window_t0 = time.time()
                self._tick_block()
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
                # window = block dispatch -> everything flushed, so the
                # tick_ms percentiles include interleaved prefill work but
                # not host-side admission
                sync(self.device)
                now = time.time()
                if ran_block:
                    self._window_walls.append((now - window_t0, K))
                self._drain(ticks)
                ran_block = False
            elif (queue and not self._active and not self._pf
                  and not self._finished):
                # pages exhausted by queued work that can never fit together
                req = queue.popleft()
                req.rejected = True
                req.done = True

        wall = time.time() - t0
        served = [r for r in requests if not r.rejected]
        toks = sum(len(r.out) for r in served)
        lat = sorted((r.finish_tick - r.arrival) for r in served
                     if r.finish_tick >= 0)
        per_tick = sorted(w / n for w, n in self._window_walls if n)
        stats = {
            "engine": "paged",
            "requests": len(requests),
            "rejected": sum(r.rejected for r in requests),
            "tokens": toks,
            "ticks": ticks,
            "wall_s": wall,
            "tok_per_s": toks / max(wall, 1e-9),
            "p50_latency_ticks": _pct(lat, 0.50),
            "p99_latency_ticks": _pct(lat, 0.99),
            "tick_ms_p50": _pct(per_tick, 0.50) * 1e3,
            "tick_ms_p99": _pct(per_tick, 0.99) * 1e3,
            "prefill_stall_fraction": (
                self.stats_counters["stall_ticks"]
                / max(ticks + self.stats_counters["stall_ticks"], 1)),
            "page_utilization": self.kv.stats().utilization,
        }
        stats.update(self.stats_counters)
        return stats


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
    print(f"[serve {args.arch}] {stats}")


if __name__ == "__main__":
    main()
