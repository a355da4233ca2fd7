"""Flash attention: the wrapper of the hand-written Hopper kernel
``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py::_flash_kernel``.

On a CUDA tensor ``flash_attention`` launches the kernel or raises; on a CPU
tensor it runs the plain version, ``flash_attention_plain`` (the f32
explicit-mask oracle of ``kernels/ref.py``).  The kernel's source carries the
note on what bounds it on the card and what its design does about it.

The kernel has three bodies, chosen by shape and dtype in C
(``select_body``): ``wgmma`` for bf16 at D in {64, 128, 192, 256} and Dv in
{64, 128, 256}, ``mma`` for the other bf16 head dims, ``fma`` for f32.  The
``wgmma`` body runs the work items of ``split_plan``; its plain twin,
``flash_attention_split_plain``, computes the same partials and merges them
with the merge kernel's formula, so the CPU tests hold the split algorithm
against the reference.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref as flash_attention_plain

#: kernel launches since the last reset (the plain version never counts)
launches = 0

SUPPORTED_DV = (16, 32, 64, 80, 96, 128, 256)
MAX_D = 256
BLOCK_Q = BLOCK_K = 64
#: SMs of an H100 SXM: the split plan aims at one wave of this many CTAs
N_SM = 132
LOG2E = 1.4426950408889634
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: body requests of the C entry, and the names of the bodies it runs
_BODY_REQUEST = {None: 0, "mma": 1, "wgmma": 2}
BODY_NAMES = {0: "fma", 1: "mma", 2: "wgmma"}
_ENCODE_ERROR = 100000
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.repro_flash_attention_fwd.argtypes = (
            [p, p, p, p, p] + [i] * 11 + [f, f, i, p, i, p, i, p, p, p])
        lib.repro_flash_attention_fwd.restype = ctypes.c_int
        lib.repro_flash_attention_select.argtypes = [i, i, i, f, i]
        lib.repro_flash_attention_select.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=64)
def select_body(dtype: torch.dtype, D: int, Dv: int, scale: float,
                body: str | None = None) -> str:
    """The body the kernel runs for this shape and dtype (``body`` asks for
    one: "mma" or "wgmma"); raises if the request cannot run.  The C entry
    decides."""
    code = _kernel().repro_flash_attention_select(
        _DTYPE_CODE[dtype], D, Dv, float(scale), _BODY_REQUEST[body])
    if code < 0:
        raise ValueError(f"no {body or 'flash'} body for {dtype}, D={D}, "
                         f"Dv={Dv}, scale={scale}")
    return BODY_NAMES[code]


class SplitPlan(NamedTuple):
    """Work items of the wgmma body, heaviest first: rows (b, h, q tile,
    first key tile, end key tile, partial slot or -1); merges of the split
    units: rows (b, h, q tile, first slot, parts); partial slots used."""
    items: tuple
    merges: tuple
    n_slots: int


def _key_tiles(qt: int, Sq: int, Skv: int, causal: bool, window: int,
              q_offset: int, block_q: int = BLOCK_Q,
              block_k: int = BLOCK_K) -> tuple[int, int]:
    """Key tiles [begin, end) that some row of q tile ``qt`` sees: the rows'
    visible keys form one interval, so no tile in the range is fully
    masked and none outside it is visible."""
    q0 = qt * block_q
    q_last = min(Sq, q0 + block_q) - 1
    end = Skv
    if causal:
        end = min(end, q_offset + q_last + 1)
    start = max(0, q_offset + q0 - window + 1) if window > 0 else 0
    if end <= start:
        return 0, 0
    return start // block_k, -(-end // block_k)


def split_plan(B: int, Sq: int, Skv: int, Hq: int, causal: bool, window: int,
               q_offset: int, block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
               n_sm: int = N_SM) -> SplitPlan:
    """A unit is (b, h, q tile).  Where there are fewer units than SMs, or
    the longest walks more than twice the mean number of key tiles, every
    unit longer than ceil(total tile-steps / n_sm) is cut into that many
    tiles or fewer, as evenly as it goes.  Items are ordered heaviest first
    (ties in (b, h, q tile) order); slots number the parts of split units."""
    n_qt = -(-Sq // block_q)
    ranges = [_key_tiles(qt, Sq, Skv, causal, window, q_offset, block_q,
                        block_k) for qt in range(n_qt)]
    counts = [e - s for s, e in ranges]
    units = B * Hq * n_qt
    total = B * Hq * sum(counts)
    split = total > 0 and (units < n_sm or max(counts) * units > 2 * total)
    cap = max(1, -(-total // n_sm))
    items, merges, slot = [], [], 0
    for b in range(B):
        for h in range(Hq):
            for qt, (s, e) in enumerate(ranges):
                n = e - s
                if not split or n <= cap:
                    items.append((b, h, qt, s, e, -1))
                    continue
                parts = -(-n // cap)
                base, extra = divmod(n, parts)
                merges.append((b, h, qt, slot, parts))
                for i in range(parts):
                    size = base + (i < extra)
                    items.append((b, h, qt, s, s + size, slot))
                    s += size
                    slot += 1
    items.sort(key=lambda it: it[3] - it[4])  # stable: heaviest first
    return SplitPlan(tuple(items), tuple(merges), slot)


@functools.lru_cache(maxsize=256)
def _device_plan(key: tuple, device: torch.device):
    """The plan of ``key`` and its rows as int32 (n, 8) tensors on the
    device.  The rows go up from pinned memory without a stream sync; the
    host allocator keeps the pinned block until the copy has run."""
    plan = split_plan(*key)

    def rows(rs):
        t = torch.zeros((max(1, len(rs)), 8), dtype=torch.int32)
        if rs:
            t[:len(rs), :len(rs[0])] = torch.tensor(rs, dtype=torch.int32)
        return t.pin_memory().to(device, non_blocking=True)

    return plan, rows(plan.items), rows(plan.merges)


def flash_attention_split_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                window: int = 0, scale: float | None = None,
                                q_offset: int = 0, out_scale: float = 1.0,
                                residual: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """The wgmma body's algorithm in plain PyTorch, f32: each work item of
    ``split_plan`` computes its rows' unnormalised o, max (log2 units, -inf
    when it saw no key) and sum l over its key tiles; an unsplit item
    normalises at once, a split unit merges its parts in order:
    M = max_p m_p, w_p = 2^(m_p - M), out = sum w_p o_p / sum w_p l_p, and
    l == 0 (no part saw a key) gives 0.  Then out * out_scale + residual."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    sl2 = scale * LOG2E
    plan = split_plan(B, Sq, Skv, Hq, bool(causal), int(window), int(q_offset))
    out = torch.zeros((B, Sq, Hq, Dv), dtype=torch.float32, device=q.device)
    part_o = torch.zeros((plan.n_slots, BLOCK_Q, Dv), device=q.device)
    part_m = torch.full((plan.n_slots, BLOCK_Q), -math.inf, device=q.device)
    part_l = torch.zeros((plan.n_slots, BLOCK_Q), device=q.device)
    for b, h, qt, kt0, kt1, slot in plan.items:
        q0 = qt * BLOCK_Q
        nr = min(Sq, q0 + BLOCK_Q) - q0
        k0, k1 = kt0 * BLOCK_K, min(kt1 * BLOCK_K, Skv)
        o = torch.zeros((nr, Dv), device=q.device)
        m = torch.full((nr,), -math.inf, device=q.device)
        l = torch.zeros((nr,), device=q.device)
        if k1 > k0:
            s = q[b, q0:q0 + nr, h].float() @ k[b, k0:k1, h // G].float().T
            pq = q_offset + torch.arange(q0, q0 + nr, device=q.device)[:, None]
            pk = torch.arange(k0, k1, device=q.device)[None, :]
            vis = torch.ones_like(s, dtype=torch.bool)
            if causal:
                vis &= pk <= pq
            if window > 0:
                vis &= (pq - pk) < window
            s = s.masked_fill(~vis, -math.inf)
            m = s.amax(-1)
            ms = torch.where(m == -math.inf, 0.0, m * sl2)
            p = torch.exp2(s * sl2 - ms[:, None])
            l = p.sum(-1)
            o = p @ v[b, k0:k1, h // G].float()
            m = torch.where(m == -math.inf, m, m * sl2)
        if slot < 0:
            out[b, q0:q0 + nr, h] = o / torch.where(l == 0, 1.0, l)[:, None]
        else:
            part_o[slot, :nr], part_m[slot, :nr], part_l[slot, :nr] = o, m, l
    for b, h, qt, slot0, n in plan.merges:
        q0 = qt * BLOCK_Q
        nr = min(Sq, q0 + BLOCK_Q) - q0
        pm = part_m[slot0:slot0 + n, :nr]
        mmax = pm.amax(0)
        wt = torch.where(mmax == -math.inf, 0.0, torch.exp2(pm - mmax))
        l = (part_l[slot0:slot0 + n, :nr] * wt).sum(0)
        o = (part_o[slot0:slot0 + n, :nr] * wt[..., None]).sum(0)
        out[b, q0:q0 + nr, h] = o / torch.where(l == 0, 1.0, l)[:, None]
    out = out * out_scale
    if residual is not None:
        out = out + residual.float()
    return out.to(q.dtype)


def _check(q, k, v, residual):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes (B, S, H, D) tensors")
    B, Sq, Hq, D = q.shape
    Bk, Skv, Hkv, Dk = k.shape
    if v.shape[:3] != k.shape[:3] or Bk != B or Dk != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv or Sq == 0 or Skv == 0:
        raise ValueError(f"bad head/sequence counts: q {tuple(q.shape)} "
                         f"k {tuple(k.shape)}")
    Dv = v.shape[-1]
    if D > MAX_D or Dv not in SUPPORTED_DV:
        raise ValueError(f"head dims D={D}, Dv={Dv} not supported "
                         f"(D <= {MAX_D}, Dv in {SUPPORTED_DV})")
    tensors = [q, k, v] + ([residual] if residual is not None else [])
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"inputs must share one dtype of {list(_DTYPE_CODE)}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("inputs must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention takes contiguous tensors")
    if q.dtype == torch.bfloat16:  # the tensor-core bodies' 16-byte tile loads
        if D % 16 or any(t.data_ptr() % 16 for t in tensors):
            raise ValueError(f"bf16 flash_attention needs D % 16 == 0 (D={D}) "
                             "and 16-byte aligned tensors")
    if residual is not None and residual.shape != (B, Sq, Hq, Dv):
        raise ValueError(f"residual must be {(B, Sq, Hq, Dv)}, "
                         f"got {tuple(residual.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None, q_offset: int = 0,
                    out_scale: float = 1.0,
                    residual: torch.Tensor | None = None,
                    _body: str | None = None) -> torch.Tensor:
    """q: (B,Sq,Hq,D); k: (B,Skv,Hkv,D); v: (B,Skv,Hkv,Dv); residual:
    (B,Sq,Hq,Dv) or None -> (B,Sq,Hq,Dv) in q's dtype.  Positions are
    contiguous: pos_q = q_offset + arange(Sq), pos_k = arange(Skv).

    ``_body`` ("mma" or "wgmma") asks the CUDA kernel for one body, so that
    a check can time the bodies against each other; callers leave it None."""
    global launches
    _check(q, k, v, residual)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if _body not in _BODY_REQUEST:
        raise ValueError(f"unknown body {_body!r}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset,
                                     out_scale=out_scale, residual=residual)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    scale = scale if scale is not None else D ** -0.5
    lib = _kernel()
    body = select_body(q.dtype, D, Dv, scale, _body)
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    items = merges = part_o = part_ml = None
    n_items = n_merges = 0
    if body == "wgmma":
        plan, items_t, merges_t = _device_plan(
            (B, Sq, Skv, Hq, bool(causal), int(window), int(q_offset)), q.device)
        n_items, n_merges = len(plan.items), len(plan.merges)
        items, merges = items_t.data_ptr(), merges_t.data_ptr()
        if n_merges:  # one f32 scratch: o (slots, 64, Dv), then (m, l) (slots, 2, 64)
            o_size = plan.n_slots * BLOCK_Q * Dv
            part = torch.empty(o_size + plan.n_slots * 2 * BLOCK_Q,
                               dtype=torch.float32, device=q.device)
            part_o, part_ml = part.data_ptr(), part.data_ptr() + 4 * o_size

    def launch():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        return lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(), _DTYPE_CODE[q.dtype], B, Sq, Skv, Hq, Hkv, D, Dv,
            int(causal), int(window), int(q_offset), float(scale),
            float(out_scale), _BODY_REQUEST[_body], items, n_items, merges,
            n_merges, part_o, part_ml, stream)

    if q.device.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(q.device):
            err = launch()
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed "
                           f"(CUresult {err - _ENCODE_ERROR})")
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
