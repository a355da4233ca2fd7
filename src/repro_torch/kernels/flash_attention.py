"""Flash attention: the wrapper of the hand-written Hopper kernel
``csrc/flash_attention.cu``, which replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py::_flash_kernel``.

On a CUDA tensor ``flash_attention`` launches the kernel or raises; on a CPU
tensor it runs the plain version, ``flash_attention_plain`` (the f32
explicit-mask oracle of ``kernels/ref.py``).  The kernel's source carries the
note on what bounds it on the card and what its design does about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_ref as flash_attention_plain

#: kernel launches since the last reset (the plain version never counts)
launches = 0

SUPPORTED_DV = (16, 32, 64, 80, 96, 128, 256)
MAX_D = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fwd = None


def _kernel():
    global _fwd
    if _fwd is None:
        lib = build.load("flash_attention")
        fn = lib.repro_flash_attention_fwd
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
        _fwd = fn
    return _fwd


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
    if q.dtype == torch.bfloat16:  # the tensor-core body's 16-byte tile loads
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
                    residual: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B,Sq,Hq,D); k: (B,Skv,Hkv,D); v: (B,Skv,Hkv,Dv); residual:
    (B,Sq,Hq,Dv) or None -> (B,Sq,Hq,Dv) in q's dtype.  Positions are
    contiguous: pos_q = q_offset + arange(Sq), pos_k = arange(Skv)."""
    global launches
    _check(q, k, v, residual)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset,
                                     out_scale=out_scale, residual=residual)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(), _DTYPE_CODE[q.dtype], B, Sq, Skv, Hq, Hkv, D, Dv,
            int(causal), int(window), int(q_offset), float(scale),
            float(out_scale), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
