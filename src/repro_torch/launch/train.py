"""End-to-end training driver: data pipeline -> train step -> checkpoint /
restart fault tolerance (port of ``repro.launch.train``).

Runs on one card (``--device cuda``, the default) or on the CPU
(``--device cpu``), eagerly: autograd for the gradients, then the in-place
AdamW.  Auto-resume: the latest committed checkpoint under ``--ckpt-dir`` is
picked up after any crash or preemption (``--preempt-at`` simulates one:
the writer is drained and the process exits with code 17).  Training runs
no hand-written kernel: neither the flash nor the WKV kernel has a
backward, in the JAX package or here, so attention trains through the plain
``attention_core`` and RWKV-6 through the chunked form.

    python -m repro_torch.launch.train --device cpu --arch rwkv6-1.6b \\
        --steps 4 --batch 2 --seq 32 --log-every 2 --ckpt-dir /tmp/ck
"""
from __future__ import annotations

import argparse
import importlib
import time
from typing import Any

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, list_configs
from repro_torch.data import TokenDataset
from repro_torch.models import LanguageModel
from repro_torch.optim import AdamW, OptConfig
from repro_torch.utils import tree_leaves, tree_unflatten


def smoke_config(arch: str):
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    return mod.smoke()


def make_train_step(model: LanguageModel, opt: AdamW):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients by autograd, then ``opt.update``,
    which overwrites ``params`` and the moments in place.  A weight the
    loss does not read (the token table when ``batch["embeds"]`` replaces
    it) gets a zero gradient, as under ``jax.grad``.  ``metrics`` holds
    ``train_loss``'s metrics and the optimizer's stats as 0-d device
    tensors, so a step does not wait for the card."""

    def train_step(params: dict, opt_state: dict, batch: dict):
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        total, metrics = model.train_loss(params, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
        # drop the graph before the update: the bf16 weight copies it holds
        # are 5 GB at gemma-2b's width
        metrics = {k: v.detach() for k, v in metrics.items()}
        del total
        params, opt_state, stats = opt.update(tree_unflatten(params, grads),
                                              opt_state, params)
        return params, opt_state, {**metrics, **stats}

    return train_step


def train(arch: str = "gemma-2b", smoke: bool = True, steps: int = 50,
          global_batch: int = 8, seq_len: int = 128, peak_lr: float = 3e-3,
          ckpt_dir: str | None = None, save_every: int = 20,
          log_every: int = 10, resume: bool = True, seed: int = 0,
          preempt_at: int | None = None, partition: str = "2024-01/all",
          device: torch.device | str = "cuda") -> dict[str, Any]:
    """Train ``arch`` for ``steps`` steps from seed-``seed`` weights (or from
    the latest checkpoint in ``ckpt_dir``).  Metrics are read on the host
    only at log steps (every ``log_every`` and the last): ``history`` holds
    those, each with ``step`` and ``wall_s`` since the loop began."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if cfg.enc_dec:  # the reference's train() would fail on batch["frames"]
        raise ValueError(f"{arch}: train() feeds token batches only, and an "
                         "encoder-decoder model needs frames; call "
                         "LanguageModel.train_loss with batch['frames']")
    model = LanguageModel(cfg, device=device)
    opt = AdamW(OptConfig(peak_lr=peak_lr, warmup_steps=max(2, steps // 10),
                          decay_steps=max(steps, 10)))
    data = TokenDataset(vocab_size=cfg.vocab_size, seq_len=seq_len,
                        global_batch=global_batch, partition=partition)

    params = model.init(seed)
    opt_state = opt.init(params)
    step = 0

    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3)
        if resume:
            got = mgr.restore_latest({"params": params, "opt_state": opt_state},
                                     device=device)
            if got is not None:
                step, tree = got
                params, opt_state = tree["params"], tree["opt_state"]
                print(f"[train] resumed from step {step}")

    train_step = make_train_step(model, opt)
    history: list[dict[str, float]] = []
    t0 = time.time()
    while step < steps:
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(step).items()}
        params, opt_state, metrics = train_step(params, opt_state, batch)
        step += 1
        if step % log_every == 0 or step == steps:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = time.time() - t0
            history.append(m)
            print(f"[train {arch}] step {step}: loss={m['loss']:.4f} "
                  f"aux_loss={m['aux_loss']:.4f} gnorm={m['grad_norm']:.3f} "
                  f"lr={m['lr']:.2e}")
        if mgr and (step % save_every == 0 or step == steps):
            mgr.save(step, {"params": params, "opt_state": opt_state},
                     metadata={"arch": arch, "step": step})
        if preempt_at is not None and step >= preempt_at:
            if mgr:
                mgr.wait()
            print(f"[train] simulated preemption at step {step}")
            raise SystemExit(17)  # preemption exit code
    if mgr:
        mgr.wait()

    losses = [h["loss"] for h in history]
    return {"history": history, "final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None, "steps": step,
            "params": params}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="gemma-2b", choices=list_configs())
    ap.add_argument("--full", action="store_true",
                    help="use the full config, not the smoke one")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--preempt-at", type=int, default=None)
    ap.add_argument("--partition", default="2024-01/all")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = train(arch=args.arch, smoke=not args.full, steps=args.steps,
                global_batch=args.batch, seq_len=args.seq, peak_lr=args.lr,
                ckpt_dir=args.ckpt_dir, save_every=args.save_every,
                log_every=args.log_every, resume=not args.no_resume,
                preempt_at=args.preempt_at, partition=args.partition,
                device=args.device)
    print(f"[train] done: first_loss={out['first_loss']:.4f} "
          f"final_loss={out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
