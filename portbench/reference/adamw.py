"""Plain AdamW with linear warm-up, cosine decay and global-norm clipping,
written from its equations, in float32.

    lr_t = peak t / warmup                        (t < warmup)
         = peak (r + (1 - r) (1 + cos(pi min(1, (t - warmup) / (decay - warmup)))) / 2)
    c = min(1, clip / (||g|| + 1e-9))      over every gradient
    m = b1 m + (1 - b1) c g;  v = b2 v + (1 - b2) (c g)^2
    p = p - lr_t ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p)

with ``wd p`` only for a weight whose stored tensor has rank >= 2 (so a
layer-stacked vector decays too).
"""
from __future__ import annotations

import math

import torch


def lr_at(o: dict, t: int) -> float:
    if t < o["warmup_steps"]:
        return o["peak_lr"] * t / max(1, o["warmup_steps"])
    prog = min(1.0, max(0.0, (t - o["warmup_steps"])
                        / max(1, o["decay_steps"] - o["warmup_steps"])))
    r = o["min_lr_ratio"]
    return o["peak_lr"] * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


class AdamW:
    def __init__(self, opt: dict, params: dict):
        self.o = opt
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """Update ``params`` in place; returns the clipped gradients."""
        o = self.o
        self.t += 1
        t = self.t
        gnorm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
        c = min(1.0, o["grad_clip"] / (float(gnorm) + 1e-9))
        lr = lr_at(o, t)
        b1, b2 = o["b1"], o["b2"]
        clipped = {}
        for k, p in params.items():
            g = grads[k] * c
            clipped[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (self.m[k] / (1 - b1 ** t)) / (
                (self.v[k] / (1 - b2 ** t)).sqrt() + o["eps"])
            if p.ndim >= 2:
                u = u + o["weight_decay"] * p
            p.sub_(lr * u)
        return clipped
