"""RWKV-6 WKV scan: the wrapper of the hand-written Hopper kernel
``csrc/linear_scan.cu``, which replaces the Pallas TPU kernel
``src/repro/kernels/linear_scan.py::_wkv_kernel``.

On a CUDA tensor ``linear_scan`` launches the kernel or raises; on a CPU
tensor it runs the plain version, ``linear_scan_plain``: the chunked-parallel
form that the JAX model computes on this path
(``models/recurrent.py::wkv_chunked``), behind the kernel's pad-to-chunk
interface.  The kernel's source carries the note on what bounds it on the
card and what its design does about it.

The kernel has two bodies.  The chunked body, the default at every shape,
runs chunks of ``KERNEL_CHUNK`` steps as 3xTF32 tensor-core products in
three launches (chunk products, state scan, output); its plain twin,
``linear_scan_chunked_plain``, computes the same passes with the same
sub-chunk anchors, zero-filled tail and emulated 3xTF32 split, so the CPU
tests hold the algorithm against the references.  The step body walks one
token at a time and runs only when asked for (``_body="step"``), to time
the two against each other.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

#: kernel launches since the last reset (the plain version never counts)
launches = 0

SUPPORTED_N = (16, 32, 64)
#: steps per chunk of the chunked body (``repro_linear_scan_chunk`` in C)
KERNEL_CHUNK = 64
#: query rows per sub-chunk: the unit of the off-diagonal anchors
SUB_CHUNK = 16
LOG2E = 1.4426950408889634
#: body requests of the C entry
BODIES = {"chunked": 0, "step": 1}
_fwd = None


def _kernel():
    global _fwd
    if _fwd is None:
        lib = build.load("linear_scan")
        if lib.repro_linear_scan_chunk() != KERNEL_CHUNK:
            raise RuntimeError("linear_scan: the kernel's chunk is not "
                               f"{KERNEL_CHUNK}")
        fn = lib.repro_linear_scan_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def scratch_floats(B: int, S: int, H: int, N: int) -> int:
    """f32 scratch of the chunked body: each chunk's state update, then its
    start state (B, nc, H, N, N), and its decay e^{p_last} (B, nc, H, N);
    none for a single chunk, which the output kernel finishes alone."""
    nc = math.ceil(S / KERNEL_CHUNK)
    return B * nc * H * N * (N + 1) if nc > 1 else 0


def _check(r, k, v, log_w, u, s0):
    if build.any_dtensor(r, k, v, log_w, u, s0):
        raise TypeError("linear_scan takes plain tensors, not DTensors: under "
                        "a mesh call it on each rank's local shards "
                        "(models/recurrent.py::_local)")
    if any(t.ndim != 4 for t in (r, k, v, log_w)):
        raise ValueError("linear_scan takes (B, S, H, N) r, k, v and log_w")
    B, S, H, N = r.shape
    if k.shape != r.shape or v.shape != r.shape or log_w.shape != r.shape:
        raise ValueError(f"shape mismatch: r {tuple(r.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} log_w {tuple(log_w.shape)}")
    if u.shape != (H, N) or s0.shape != (B, H, N, N):
        raise ValueError(f"u must be {(H, N)} and s0 {(B, H, N, N)}, got "
                         f"{tuple(u.shape)} and {tuple(s0.shape)}")
    if B == 0 or S == 0 or H == 0:
        raise ValueError(f"empty input: r {tuple(r.shape)}")
    if N not in SUPPORTED_N:
        raise ValueError(f"head size N={N} not supported (N in {SUPPORTED_N})")
    tensors = (r, k, v, log_w, u, s0)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("linear_scan takes float32 inputs only")
    if any(t.device != r.device for t in tensors):
        raise ValueError("inputs must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("linear_scan takes contiguous tensors")
    if build.misaligned(tensors):  # the kernel's 16-byte copies
        raise ValueError("linear_scan needs 16-byte aligned tensors")


def linear_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                      *, chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad S to a multiple of the chunk, run ``wkv_chunked``, slice back.
    Padded steps carry log_w = 0 (decay 1) and k = 0, so the state passes
    through them unchanged and ``s_fin`` stays exact."""
    from repro_torch.models.recurrent import wkv_chunked  # import cycle

    S = r.shape[1]
    c = min(chunk, S)
    pad = -S % c
    if pad:
        r, k, v, log_w = (F.pad(t, (0, 0, 0, 0, 0, pad))
                          for t in (r, k, v, log_w))
    y, s_fin = wkv_chunked(r, k, v, log_w, u, s0, chunk=c)
    return y[:, :S], s_fin


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round toward zero to TF32: clear the low 13 mantissa bits."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's 3xTF32 mma: x = big + small, both TF32;
    small*big + big*small + big*big, each product exact in f32."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return a_s @ bb + ab @ b_s + ab @ bb


def _cumsum_log2(lw: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum of log_w * log2(e) down dim -2 (the chunk's
    steps), as the kernel sums it: each column cut into 256 / N segments,
    each summed in order, then each segment adds the running total of the
    ones before it.  Never rises down a column."""
    x = lw * LOG2E
    out = torch.empty_like(x)
    C, N = x.shape[-2:]
    seg = C // (256 // N)
    total = None
    for t0 in range(0, C, seg):
        acc = torch.zeros_like(x[..., 0, :])
        for t in range(t0, t0 + seg):
            acc = acc + x[..., t, :]
            out[..., t, :] = acc
        if total is None:
            total = acc
        else:
            out[..., t0:t0 + seg, :] += total[..., None, :]
            total = total + acc
    return out


def linear_scan_chunked_plain(r: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, log_w: torch.Tensor,
                              u: torch.Tensor, s0: torch.Tensor, *,
                              trace: dict | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked body's algorithm on plain tensors, pass for pass: chunks
    of ``KERNEL_CHUNK`` steps zero-filled past S (log_w = 0, k = 0), the
    chunk products U = k_hat^T V and decays g = e^{p_last}, the state scan
    S <- g * S + U that yields each chunk's start state, then per chunk
    y = (r e^{p_prev}) S_start + A V, with A's diagonal 16 x 16 tiles
    elementwise (u-bonus on the diagonal) and its off-diagonal tiles
    anchored at each query sub-chunk's first p_prev.  Products are emulated
    3xTF32, exponentials base 2 on log2-scaled decays.  (With one chunk
    the kernel does all three passes in its output kernel; the arithmetic
    is the same.)  ``trace``, if given,
    receives ``max_exp_arg``, the largest argument of any exp computed, and
    ``start_states`` (B, nc, H, N, N), each chunk's start state."""
    B, S, H, N = r.shape
    C, L = KERNEL_CHUNK, SUB_CHUNK
    nc = -(-S // C)
    max_arg = [-math.inf]

    def ex2(x):
        if x.numel():
            max_arg[0] = max(max_arg[0], float(x.max()))
        return torch.exp2(x)

    def chunks(x):  # (B, S, H, N) -> zero-filled (B, nc, H, C, N)
        out = x.new_zeros((B, nc * C, H, N))
        out[:, :S] = x
        return out.reshape(B, nc, C, H, N).transpose(2, 3)

    rc, kc, vc, lwc = (chunks(t.float()) for t in (r, k, v, log_w))
    p = _cumsum_log2(lwc)  # inclusive
    pp = torch.cat([torch.zeros_like(p[..., :1, :]), p[..., :-1, :]], -2)
    p_last = p[..., -1:, :]

    # pass 1: the chunks' own state updates and decays
    U = _mm3((kc * ex2(p_last - p)).transpose(-1, -2), vc)
    g = ex2(p_last).transpose(-1, -2)  # (B, nc, H, N, 1)
    # pass 2: the scan over chunks, in order
    state, starts = s0.float(), []
    for c in range(nc):
        starts.append(state)
        state = g[:, c] * state + U[:, c]
    s_start = torch.stack(starts, 1)
    # pass 3: A, then y
    A = rc.new_zeros(rc.shape[:-1] + (C,))
    lower = torch.tril(torch.ones((L, L), dtype=torch.bool), -1)[..., None]
    for t0 in range(0, C, L):
        rows = slice(t0, t0 + L)
        r_i, k_i = rc[..., rows, :], kc[..., rows, :]
        diff = pp[..., rows, None, :] - p[..., None, rows, :]  # [t, s, n]
        decay = torch.zeros_like(diff)
        decay[..., lower[..., 0], :] = ex2(diff[..., lower[..., 0], :])
        tile = torch.einsum("...tn,...sn,...tsn->...ts", r_i, k_i, decay)
        bonus = (r_i * u.float()[:, None, :] * k_i).sum(-1)
        A[..., rows, rows] = tile + torch.diag_embed(bonus)
        if t0:
            anchor = pp[..., t0:t0 + 1, :]
            r_hat = r_i * ex2(pp[..., rows, :] - anchor)
            k_hat = kc[..., :t0, :] * ex2(anchor - p[..., :t0, :])
            A[..., rows, :t0] = _mm3(r_hat, k_hat.transpose(-1, -2))
    y = _mm3(rc * ex2(pp), s_start) + _mm3(A, vc)
    y = y.transpose(2, 3).reshape(B, nc * C, H, N)[:, :S]
    if trace is not None:
        trace.update(max_exp_arg=max_arg[0], start_states=s_start)
    return y.contiguous(), state


def linear_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
                chunk: int = 64, _body: str = "chunked"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, log_w: (B, S, H, N) f32 with log_w <= 0; u: (H, N); s0:
    (B, H, N, N) -> y (B, S, H, N), s_fin (B, H, N, N), both f32.

        y_t = r_t . (S_{t-1} + (u*k_t) v_t^T);  S_t = diag(e^{log_w_t}) S_{t-1} + k_t v_t^T

    ``chunk`` is the plain version's chunk length on a CPU tensor; the
    kernel's chunked body always works in chunks of ``KERNEL_CHUNK`` = 64
    steps and masks a ragged last chunk itself.  ``_body="step"`` asks the
    kernel for its per-step body, so that a check can time the two bodies;
    callers leave it at the default."""
    global launches
    _check(r, k, v, log_w, u, s0)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if _body not in BODIES:
        raise ValueError(f"unknown body {_body!r}")
    if r.device.type == "cpu":
        return linear_scan_plain(r, k, v, log_w, u, s0, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"no linear_scan kernel for device {r.device}")
    B, S, H, N = r.shape
    y = torch.empty_like(r)
    s_fin = torch.empty_like(s0)
    n_scratch = scratch_floats(B, S, H, N) if _body == "chunked" else 0
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=r.device)
               if n_scratch else None)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        log_w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                        y.data_ptr(), s_fin.data_ptr(),
                        scratch.data_ptr() if scratch is not None else None,
                        B, S, H, N, BODIES[_body], stream)
    if err:
        raise RuntimeError(f"linear_scan kernel launch failed ({_body} body): "
                           f"CUDA error {err}")
    launches += 1
    return y, s_fin
