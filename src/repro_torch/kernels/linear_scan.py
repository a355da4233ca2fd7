"""RWKV-6 WKV scan: the wrapper of the hand-written Hopper kernel
``csrc/linear_scan.cu``, which replaces the Pallas TPU kernel
``src/repro/kernels/linear_scan.py::_wkv_kernel``.

On a CUDA tensor ``linear_scan`` launches the kernel or raises; on a CPU
tensor it runs the plain version, ``linear_scan_plain``: the chunked-parallel
form that the JAX model computes on this path
(``models/recurrent.py::wkv_chunked``), behind the kernel's pad-to-chunk
interface.  The kernel's source carries the note on what bounds it on the
card and what its design does about it.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

#: kernel launches since the last reset (the plain version never counts)
launches = 0

SUPPORTED_N = (16, 32, 64)
_fwd = None


def _kernel():
    global _fwd
    if _fwd is None:
        lib = build.load("linear_scan")
        fn = lib.repro_linear_scan_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


def _check(r, k, v, log_w, u, s0):
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
    if any(t.data_ptr() % 16 for t in tensors):  # the kernel's 16-byte copies
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


def linear_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
                chunk: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, log_w: (B, S, H, N) f32 with log_w <= 0; u: (H, N); s0:
    (B, H, N, N) -> y (B, S, H, N), s_fin (B, H, N, N), both f32.

        y_t = r_t . (S_{t-1} + (u*k_t) v_t^T);  S_t = diag(e^{log_w_t}) S_{t-1} + k_t v_t^T

    ``chunk`` is the plain version's chunk length; the kernel steps one
    token at a time and needs none."""
    global launches
    _check(r, k, v, log_w, u, s0)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if r.device.type == "cpu":
        return linear_scan_plain(r, k, v, log_w, u, s0, chunk=chunk)
    if r.device.type != "cuda":
        raise ValueError(f"no linear_scan kernel for device {r.device}")
    B, S, H, N = r.shape
    y = torch.empty_like(r)
    s_fin = torch.empty_like(s0)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        log_w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                        y.data_ptr(), s_fin.data_ptr(), B, S, H, N, stream)
    if err:
        raise RuntimeError(f"linear_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, s_fin
