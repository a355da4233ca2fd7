"""AdamW with warmup + cosine schedule and global-norm clipping (port of
``repro.optim.adamw``).

The update is JAX's functional one (``repro/optim/adamw.py:56-82``), done in
place under ``torch.no_grad()``: parameters, moments and gradients are
overwritten, so at gemma-2b's width no second copy of the 40 GB of f32
state is made.  Scalars (the step, the learning rate, the clip factor, the
bias corrections) are f32 tensors, as JAX computes them, not Python doubles.
Weight decay goes to every parameter whose *stored* rank is >= 2, which
includes a scanned segment's stacked vectors (norm scales ``(L, d)``,
``w0``), as in JAX; ``torch.optim.AdamW`` would decay every parameter.

Under a mesh the parameters, gradients and moments are DTensors with one
layout per leaf: the moments take their parameter's placements, the global
gradient norm reduces over every shard, and the scalars are replicated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.distributed.sharding import replicate_like
from repro_torch.utils import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def cosine_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine to ``min_lr_ratio`` of it,
    held past ``decay_steps``; f32 throughout."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(1, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.decay_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5
           * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, summed leaf by leaf in
    JAX's flattening order."""
    sq = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree))
    return torch.sqrt(sq)


class AdamW:
    def __init__(self, cfg: OptConfig):
        self.cfg = cfg

    def init(self, params: Any) -> dict:
        """Zero moments laid out as their parameters (DTensors under a
        mesh), and the step count."""
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        device = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(self, grads: Any, state: dict,
               params: Any) -> tuple[Any, dict, dict]:
        """One step.  Returns ``(params, state, stats)``: ``params`` and the
        state's ``m`` and ``v`` are the trees passed in, updated in place;
        ``grads`` (f32) are clipped in place and not needed after.  ``stats``
        holds ``lr``, ``grad_norm`` (before clipping) and ``param_norm``
        (after the step), as 0-d device tensors: nothing here waits for the
        card."""
        cfg = self.cfg
        step = state["step"] + 1
        lr = cosine_schedule(cfg, step)

        gnorm = global_norm(grads)
        clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        b1, b2 = cfg.b1, cfg.b2
        t = step.to(torch.float32)
        ref = tree_leaves(params)[0]
        lr_, bc1, bc2 = (replicate_like(x, ref)
                         for x in (lr, 1 - b1 ** t, 1 - b2 ** t))
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]), tree_leaves(state["v"])):
            g = g.float().mul_(clip)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            del g
            u = m / bc1
            u.div_((v / bc2).sqrt_().add_(cfg.eps))
            if p.ndim >= 2:  # decoupled weight decay on stored rank >= 2
                u.add_(p.float(), alpha=cfg.weight_decay)
            p.sub_(u.mul_(lr_))
        stats = {"lr": lr, "grad_norm": gnorm,
                 "param_norm": global_norm(params)}
        return params, {"m": state["m"], "v": state["v"], "step": step}, stats
