"""Shape-keyed autotuner for the port's Hopper kernels.

Port of ``repro.kernels.autotune``.  The flash-attention and WKV kernels
each take a second tile since this module was ported: the flash kernel's
``wgmma`` body runs 64- or 128-key tiles at Dv <= 128 (64-row q tiles
always: one warpgroup's ``wgmma`` M), and the WKV kernel's chunked body
32- or 64-step chunks.  The right tile depends on the shape, so this module
searches the tiles per *kernel key* (kernel name + shape signature + dtype
+ backend, the reference's format letter for letter) and memoizes the
winner:

* **Candidates** walk the Hopper ladder (``ATTN_BLOCK_Q``, ``ATTN_BLOCK_K``,
  ``SCAN_CHUNKS``), are clamped to the sequence (a tile past it runs as the
  smallest built tile that covers it) and de-duplicated, and keep only
  tiles the selected body is built for whose CTAs fit an SM's shared
  memory (``attention_smem_bytes`` / ``scan_smem_bytes``, the C entries'
  sizing byte for byte, checked on the card by ``chip_smoke.py``).  The
  kernels mask ragged tails, so no divisibility is required, and the
  default tile is always a candidate.
* **Timing** (``measure_us``) runs a warm-up call, then best-of-N of
  back-to-back calls between CUDA events on the card (the host's clock
  around a synchronised call for a CPU tensor).
* **Memoization** is two-level: an in-process dict (a cache hit does zero
  timing work) backed by a JSON store that merges the committed baseline
  (``benchmarks/baselines/torch_autotune_cache.json``, written by the H100
  sweep of ``benchmarks/torch_kernel_bench.py``) with the local writable
  cache (``artifacts/torch_autotune_cache.json``, or
  ``$REPRO_TORCH_AUTOTUNE_CACHE``); local entries win.  The two packages
  never share a cache file.
* **Fallback**: a CPU tensor (or a fake tensor of the dry run) never times
  anything at dispatch: a miss resolves to the heuristic, which keeps the
  128-key tile where it costs no CTA an SM and 64-step chunks at N = 64.
  Explicit ``block_q=`` / ``block_k=`` / ``chunk=`` at the entry points
  bypass the tuner (``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Callable, Iterable, Sequence

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import linear_scan as _ls

#: shared memory an SM offers its CTAs (228 KB of the H100's 256 KB, the
#: rest L1), what the runtime keeps back of it for each CTA, and the most
#: one block may ask for
SMEM_PER_SM = 228 * 1024
SMEM_PER_CTA = 1024
SMEM_PER_BLOCK = 232_448

#: the Hopper tile ladder the search walks: the tiles the kernels are built
#: for (``flash_attention.WGMMA_BLOCK_K``, ``linear_scan.KERNEL_CHUNKS``)
ATTN_BLOCK_Q = (_fa.BLOCK_Q,)
ATTN_BLOCK_K = _fa.WGMMA_BLOCK_K
SCAN_CHUNKS = _ls.KERNEL_CHUNKS
DEFAULT_ATTN = {"block_q": _fa.BLOCK_Q, "block_k": _fa.BLOCK_K}
DEFAULT_SCAN = {"chunk": _ls.KERNEL_CHUNK}

_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_CACHE_PATH = str(_ROOT / "artifacts" / "torch_autotune_cache.json")
BASELINE_CACHE_PATH = str(_ROOT / "benchmarks" / "baselines"
                          / "torch_autotune_cache.json")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def backend_tag(device: torch.device | str) -> str:
    """Cache-key backend tag: "cuda" for the card, "cpu" for the host (whose
    plain versions ignore the tile)."""
    return torch.device(device).type


# ---------------------------------------------------------------------------
# keys (the reference's format)
# ---------------------------------------------------------------------------


def attention_key(q_shape: Sequence[int], k_shape: Sequence[int],
                  v_shape: Sequence[int], dtype, *, causal: bool,
                  window: int, backend: str) -> str:
    B, Sq, Hq, D = q_shape
    _, Skv, Hkv, _ = k_shape
    Dv = v_shape[-1]
    return ("flash_attention|" + backend + "|" + _dtype_name(dtype)
            + f"|B{B}|Sq{Sq}|Skv{Skv}|Hq{Hq}|Hkv{Hkv}|D{D}|Dv{Dv}"
            + f"|c{int(causal)}|w{window}")


def scan_key(r_shape: Sequence[int], dtype, *, backend: str) -> str:
    B, S, H, N = r_shape
    return ("linear_scan|" + backend + "|" + _dtype_name(dtype)
            + f"|B{B}|S{S}|H{H}|N{N}")


# ---------------------------------------------------------------------------
# the SM shared-memory fit (no timing)
# ---------------------------------------------------------------------------


def attention_smem_bytes(block_q: int, block_k: int, D: int, Dv: int,
                         dtype) -> int:
    """Dynamic shared memory of one CTA of the flash body that (dtype, D, Dv)
    selects, as the C entry sizes it: the wgmma body's Q tile plus a
    two-stage K/V ring in bf16 with 1 KB of alignment slack and the
    barriers; the mma.sync body's padded Q and two K/V buffers; the FMA
    body's padded f32 tiles, probabilities and row statistics."""
    body = _fa.body_of(dtype, D, Dv)
    if body == "wgmma":
        return 1024 + 2 * (block_q * D + 2 * block_k * (D + Dv)) + 64
    if body == "mma":
        return 2 * ((block_q + 2 * block_k) * (D + 8) + 2 * block_k * (Dv + 8))
    return 4 * ((block_q + block_k) * (D | 1) + block_k * (Dv | 1)
                + block_q * (block_k + 1) + 3 * block_q)


def _launch_ctas(body: str, Dv: int) -> int:
    """CTAs an SM the body's launch bound plans for: the wgmma body's
    second ``__launch_bounds__`` argument (one at Dv 256, else two); the
    mma.sync (128 threads) and FMA (256) bodies' thread count's share of
    the SM's 2048 threads."""
    if body == "wgmma":
        return 1 if Dv == 256 else 2
    return 2048 // (128 if body == "mma" else 256)


def resident_ctas(smem: int, launch_ctas: int,
                  smem_per_sm: int = SMEM_PER_SM) -> int:
    """CTAs of ``smem`` bytes each an SM holds: the launch bound's count, or
    fewer where the SM's shared memory holds fewer; 0 past a block's
    limit."""
    if smem > SMEM_PER_BLOCK:
        return 0
    return min(launch_ctas, smem_per_sm // (smem + SMEM_PER_CTA))


def attention_ctas(block_q: int, block_k: int, D: int, Dv: int, dtype,
                   smem_per_sm: int = SMEM_PER_SM) -> int:
    body = _fa.body_of(dtype, D, Dv)
    return resident_ctas(attention_smem_bytes(block_q, block_k, D, Dv, dtype),
                         _launch_ctas(body, Dv), smem_per_sm)


def scan_smem_bytes(chunk: int, N: int) -> int:
    """Shared memory of the WKV chunked body's larger CTA, as the C entry
    sizes it (``chunked_smem_bytes``): the output kernel's r, k, the
    cumulative decays (one row more), A (C x C + 4), v, the start state and
    u, against the chunk kernel's k_hat, v and decays."""
    C, row, col = chunk, N + 4, N + 8
    out = 4 * (2 * C * row + (C + 1) * row + C * (C + 4) + C * col
               + N * col + N)
    chunk_kernel = 4 * (2 * C * col + C * row)
    return max(out, chunk_kernel)


def scan_ctas(chunk: int, N: int, smem_per_sm: int = SMEM_PER_SM) -> int:
    """The chunked body's CTAs an SM: ``__launch_bounds__(256, 2)``, or
    fewer where shared memory holds fewer."""
    return resident_ctas(scan_smem_bytes(chunk, N), 2, smem_per_sm)


@dataclasses.dataclass(frozen=True)
class AttnCandidate:
    block_q: int
    block_k: int

    def as_dict(self) -> dict:
        return {"block_q": self.block_q, "block_k": self.block_k}


@dataclasses.dataclass(frozen=True)
class ScanCandidate:
    chunk: int

    def as_dict(self) -> dict:
        return {"chunk": self.chunk}


def _clamp(tile: int, S: int, ladder: Iterable[int]) -> int:
    """A tile past the sequence runs as the smallest built tile covering it."""
    cover = [t for t in ladder if t >= S]
    return min(tile, min(cover)) if cover else tile


def attention_candidates(Sq: int, Skv: int, D: int, Dv: int, dtype, *,
                         smem_per_sm: int = SMEM_PER_SM) -> list[AttnCandidate]:
    """Valid (block_q, block_k) pairs: clamped to the sequence and
    de-duplicated, built for the body that (dtype, D, Dv) selects, with at
    least one CTA an SM; the default first.  (A residual is read in the
    epilogue, not staged: it changes no tile's fit.)"""
    tiles = _fa.key_tiles(_fa.body_of(dtype, D, Dv), Dv)
    default = (DEFAULT_ATTN["block_q"], DEFAULT_ATTN["block_k"])
    pairs = [default] + [(_clamp(bq, Sq, ATTN_BLOCK_Q),
                          _clamp(bk, Skv, ATTN_BLOCK_K))
                         for bq in ATTN_BLOCK_Q for bk in ATTN_BLOCK_K]
    out: list[AttnCandidate] = []
    for bq, bk in dict.fromkeys(pairs):
        if bq != _fa.BLOCK_Q or bk not in tiles:
            continue
        if attention_ctas(bq, bk, D, Dv, dtype, smem_per_sm) < 1:
            continue
        out.append(AttnCandidate(bq, bk))
    return out


def scan_candidates(S: int, N: int, *,
                    smem_per_sm: int = SMEM_PER_SM) -> list[ScanCandidate]:
    """Valid chunks (the scan is f32 only): clamped to the sequence,
    de-duplicated, with at least one CTA an SM; the default first."""
    wanted = [DEFAULT_SCAN["chunk"]] + [_clamp(c, S, SCAN_CHUNKS)
                                        for c in SCAN_CHUNKS]
    return [ScanCandidate(c) for c in dict.fromkeys(wanted)
            if scan_ctas(c, N, smem_per_sm) >= 1]


# ---------------------------------------------------------------------------
# heuristic defaults (zero timing; a CPU tensor's misses)
# ---------------------------------------------------------------------------


def heuristic_attention(Sq: int, Skv: int, D: int, Dv: int, dtype) -> dict:
    """The 128-key tile where it keeps the body's CTAs an SM (the wgmma
    body at D 64, Dv <= 128: two either way), else the default 64."""
    cands = attention_candidates(Sq, Skv, D, Dv, dtype)
    if not cands:
        return dict(DEFAULT_ATTN)
    ctas = {c: attention_ctas(c.block_q, c.block_k, D, Dv, dtype) for c in cands}
    full = max(ctas.values())
    return max((c for c in cands if ctas[c] == full),
               key=lambda c: c.block_k).as_dict()


def heuristic_scan(S: int, N: int) -> dict:
    """64-step chunks at N <= 64 (the reference's rule), clamped to the
    sequence (one 32-step chunk covers S <= 32)."""
    want = _clamp(64 if N <= 64 else 32, S, SCAN_CHUNKS)
    cands = scan_candidates(S, N)
    if not cands:
        return dict(DEFAULT_SCAN)
    best = min(cands, key=lambda c: (abs(c.chunk - want), -c.chunk))
    return best.as_dict()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


#: calls a timing sample runs back to back, and the SM clock cycles the
#: stream spins before them (about 1.1 ms at the H100's 1.755 GHz boost
#: clock): room for the host to queue them at ~30 us each
REPS, HEAD_START_CYCLES = 10, 2_000_000


def _on_card(out) -> bool:
    first = out[0] if isinstance(out, (tuple, list)) else out
    return isinstance(first, torch.Tensor) and first.device.type == "cuda"


def measure_us(fn: Callable[[], object], *, iters: int = 3,
               warmup: int = 1) -> float:
    """Best-of-``iters`` microseconds a call of ``fn()``, after ``warmup``
    untimed calls (the kernel's build and first launch).  A call that
    returns a CUDA tensor is timed on the card: ``REPS`` calls back to back
    between two CUDA events, queued behind a spin of the stream
    (``torch.cuda._sleep``, about ``HEAD_START_CYCLES``) so that the host has
    enqueued them before the first starts: the sample is device time per
    call, not the host's ~30 us of launch work.  Anything else is timed on
    the host's clock around single calls."""
    out = None
    for _ in range(max(1, warmup)):
        out = fn()
    best = float("inf")
    if _on_card(out):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(max(1, iters)):
            torch.cuda._sleep(HEAD_START_CYCLES)
            start.record()
            for _ in range(REPS):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3 / REPS)
        return best
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


# ---------------------------------------------------------------------------
# the tuner (the reference's, unchanged but for its paths)
# ---------------------------------------------------------------------------


class Autotuner:
    """Two-level (in-process + persistent JSON) tile cache with search.

    ``timing_calls`` counts candidate measurements -- it stays 0 on cache
    hits; ``tune`` is the only method that times anything.
    """

    def __init__(self, cache_path: str | None = None,
                 baseline_path: str | None = None):
        self.cache_path = cache_path if cache_path is not None else \
            os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE", DEFAULT_CACHE_PATH)
        self.baseline_path = baseline_path if baseline_path is not None \
            else BASELINE_CACHE_PATH
        self._mem: dict[str, dict] = {}
        self._loaded = False
        self.timing_calls = 0

    # ------------------------------------------------------------ storage
    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        for path in (self.baseline_path, self.cache_path):  # local wins
            if not path or not os.path.exists(path):
                continue
            try:
                with open(path) as f:
                    data = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            for key, entry in data.get("entries", {}).items():
                if isinstance(entry, dict) and "config" in entry:
                    self._mem[key] = entry

    def _persist(self) -> None:
        if not self.cache_path:
            return
        os.makedirs(os.path.dirname(self.cache_path) or ".", exist_ok=True)
        # merge-on-write so concurrent processes lose nothing but races
        entries: dict[str, dict] = {}
        if os.path.exists(self.cache_path):
            try:
                with open(self.cache_path) as f:
                    entries = json.load(f).get("entries", {})
            except (OSError, json.JSONDecodeError):
                entries = {}
        entries.update({k: v for k, v in self._mem.items()
                        if v.get("mode") != "heuristic"})
        tmp = f"{self.cache_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "entries": entries}, f, indent=1,
                      sort_keys=True)
        os.replace(tmp, self.cache_path)

    # ------------------------------------------------------------- lookup
    def lookup(self, key: str) -> dict | None:
        """Cached entry for ``key`` or None.  Never times anything."""
        self._load()
        return self._mem.get(key)

    def put(self, key: str, entry: dict, *, persist: bool = True) -> None:
        self._mem[key] = entry
        if persist and entry.get("mode") != "heuristic":
            self._persist()

    def resolve(self, key: str, heuristic: Callable[[], dict]) -> dict:
        """Cache hit or heuristic default -- the dispatch path without
        timing.  Heuristic entries stay in-process only (a later real
        ``tune`` overrides them)."""
        hit = self.lookup(key)
        if hit is not None:
            return hit["config"]
        cfg = heuristic()
        self._mem[key] = {"config": cfg, "mode": "heuristic"}
        return cfg

    # -------------------------------------------------------------- search
    def tune(self, key: str,
             candidates: Sequence[AttnCandidate | ScanCandidate],
             measure: Callable[[dict], float], *, mode: str,
             persist: bool = True, force: bool = False) -> dict:
        """Search ``candidates`` with ``measure(config) -> us`` and memoize
        the winner.  A prior *timed* entry for ``key`` is returned as-is --
        zero timing work on a hit; a heuristic placeholder is re-tuned.
        ``force=True`` re-times even on a hit (the benchmarks use it so a
        shipped baseline never mixes with timings from another card)."""
        hit = self.lookup(key)
        if hit is not None and hit.get("mode") != "heuristic" and not force:
            return hit
        if not candidates:
            raise ValueError(f"no valid tile candidates for {key}")
        timed: list[tuple[float, dict]] = []
        for cand in candidates:
            cfg = cand.as_dict()
            self.timing_calls += 1
            timed.append((measure(cfg), cfg))
        best_us, best_cfg = min(timed, key=lambda t: t[0])
        entry = {
            "config": best_cfg,
            "us": round(best_us, 2),
            "mode": mode,
            "candidates": {json.dumps(c, sort_keys=True): round(us, 2)
                           for us, c in timed},
        }
        self.put(key, entry, persist=persist)
        return entry


_TUNER: Autotuner | None = None


def get_tuner() -> Autotuner:
    global _TUNER
    if _TUNER is None:
        _TUNER = Autotuner()
    return _TUNER


def reset_tuner() -> None:
    """Drop the process-global tuner (tests)."""
    global _TUNER
    _TUNER = None
