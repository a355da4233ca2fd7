"""Faults planted under a run, to show that the check catches them.

Each is a context manager that patches the program's classes in this
process only (never its files), for the tests and for ``control.py
--fault``:

``state_unchanged``
    serving: a prefill round's cache writes are dropped; training: the
    optimizer returns the weights and moments as they came.
``half_batch``
    serving: the second half of each prefill group is left out of the
    cache write; training: the loss is the mean over the first half of
    the rows only.
``token_altered``
    serving: the first token of every slot in each drained block is
    changed on the device before the host reads it; training: each step
    reports its loss 1 % high.
"""
from __future__ import annotations

import contextlib

FAULTS = ("state_unchanged", "half_batch", "token_altered")


@contextlib.contextmanager
def planted(name: str):
    from repro_torch.launch import paged_kv, serve
    from repro_torch.models import model
    from repro_torch.optim import adamw

    Engine, Model = serve.PagedServingEngine, model.LanguageModel
    patches = []
    if name == "state_unchanged":
        patches = [
            (paged_kv.PagedKVCache, "_scatter_impl",
             lambda self, *a, **k: None),
            (adamw.AdamW, "update",
             lambda self, grads, state, params: (params, state, {})),
        ]
    elif name == "half_batch":
        chunk, loss = Engine._chunk, Model.train_loss

        def half_chunk(self, slots, tokens, start):
            g = len(slots)
            kept = list(slots[:g // 2]) + [self.n_slots] * (g - g // 2)
            return chunk(self, kept, tokens, start)

        def half_loss(self, params, batch):
            b = batch["tokens"].shape[0] // 2
            return loss(self, params, {k: v[:b] for k, v in batch.items()})

        patches = [(Engine, "_chunk", half_chunk),
                   (Model, "train_loss", half_loss)]
    elif name == "token_altered":
        drain, loss = Engine._drain, Model.train_loss

        def altered_drain(self, now):
            self.out_buf[:, 0] = (self.out_buf[:, 0] + 1) % \
                self.model.cfg.vocab_size
            return drain(self, now)

        def altered_loss(self, params, batch):
            total, metrics = loss(self, params, batch)
            return total, {**metrics, "loss": metrics["loss"] * 1.01}

        patches = [(Engine, "_drain", altered_drain),
                   (Model, "train_loss", altered_loss)]
    else:
        raise ValueError(f"fault {name!r}; have {FAULTS}")
    saved = [(cls, attr, cls.__dict__[attr]) for cls, attr, _ in patches]
    for cls, attr, fn in patches:
        setattr(cls, attr, fn)
    try:
        yield
    finally:
        for cls, attr, fn in saved:
            setattr(cls, attr, fn)
