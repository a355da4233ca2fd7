"""Plain float32 building blocks of the reference models.

Every matrix product goes through ``Prec.mm`` / ``Prec.einsum``.  In
``"f32"`` they are float32 products with TF32 off (the reference); in
``"fp8"`` each operand is first rounded to float8 e4m3 with one scale a
tensor (its absolute maximum onto 448), and in a backward the gradient
through it to e5m2: the control that stands for a program computing in
the precision below bfloat16.  Norms, softmax,
activations and the WKV recurrence stay in float32 in both.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn
FP8_GRAD_MAX = 57344.0  # largest finite float8 e5m2


def tf32_off() -> None:
    """Keep float32 products in float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` at one scale for the whole tensor (its
    absolute maximum onto ``top``), back in float32."""
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _FP8(torch.autograd.Function):
    """Float8 as it trains: operands rounded to e4m3, and the gradient
    that flows back through them to e5m2, each at its own scale."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, FP8_GRAD_MAX)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x)


class Prec:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return fp8_round(x) if self.name == "fp8" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._q(a) @ self._q(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self._q(a), self._q(b))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions, split-half (NeoX) pairing: dims i and i + D/2 turn
    together by pos * theta^(-2i/D).  x: (S, H, D); pos: (S,)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=x.device) / d)
    ang = pos.float()[:, None] * inv  # (S, D/2)
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer(w: dict, prefix: str, i: int, name: str) -> torch.Tensor:
    """Layer ``i``'s copy of a stacked weight, in float32."""
    return w[f"{prefix}/{name}"][i].float()
