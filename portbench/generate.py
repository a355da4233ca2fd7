"""The one traffic generator: a traffic file's parameters in, requests or
token batches out, from the run's seed.

A file's ``kind`` picks the shape of what it describes:

``waves``
    Batch inference: waves of ``requests`` requests, all queued at once.
    Every wave holds the same multiset of sizes: prompt lengths at the
    quantiles (i + 1/2) / n of the ``prompt`` distribution and output
    lengths at those of the ``output`` distribution.  Wave k queues them in
    its own fixed order (a permutation of each list drawn from k alone, so
    the pairing of prompts with outputs differs from wave to wave), and the
    seed draws the token ids, uniform over the vocabulary.  So every run
    does the same work: the order of a wave moves its wall by up to a
    tenth, and left to the seed it would spread the runs.
``train_batches``
    Training: ``batch`` rows of ``seq`` tokens a step, uniform over the
    vocabulary, drawn on the device from (seed, step), and the targets are
    the rows shifted by one.

Distributions: ``{"dist": "loguniform" | "uniform", "lo": a, "hi": b}``,
whole numbers from a to b.
"""
from __future__ import annotations

import math

import numpy as np


def quantiles(spec: dict, n: int) -> list[int]:
    """The n sizes at the quantiles (i + 1/2) / n, i < n, of ``spec``."""
    lo, hi = spec["lo"], spec["hi"]
    out = []
    for i in range(n):
        q = (i + 0.5) / n
        if spec["dist"] == "loguniform":
            x = math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
        elif spec["dist"] == "uniform":
            x = lo + q * (hi - lo)
        else:
            raise ValueError(f"distribution {spec['dist']!r}")
        out.append(min(hi, max(lo, int(round(x)))))
    return out


def seeded(seed: int, *more: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, *more])


def wave(traffic: dict, vocab: int, seed: int, index: int):
    """Wave ``index`` of a ``waves`` mix: a list of (prompt ids, new tokens),
    in the order they are queued."""
    n = traffic["requests"]
    order = np.random.default_rng([1, index])
    plens = order.permutation(quantiles(traffic["prompt"], n))
    outs = order.permutation(quantiles(traffic["output"], n))
    ids = seeded(seed, 1, index).integers(0, vocab, size=int(plens.sum()),
                                        dtype=np.int64)
    reqs, at = [], 0
    for p, o in zip(plens, outs):
        reqs.append((ids[at:at + p].tolist(), int(o)))
        at += p
    return reqs


def warmup_wave(traffic: dict, engine: dict, vocab: int, seed: int):
    """The set-up's wave: one request a chunk size of the engine's ladder
    (chunk_max, chunk_max / 2, ..., 1 tokens), so every prefill round shape
    runs (a round is always padded to ``prefill_group`` rows), decoding
    long enough for the decode block to be captured as a graph and
    replayed."""
    rng = seeded(seed, 2)
    new = 3 * engine["drain_every"] + 1
    sizes, c = [], engine["chunk_max"]
    while c >= 1:
        sizes.append(c)
        c //= 2
    return [(rng.integers(0, vocab, size=s).tolist(), new) for s in sizes]


def wave_stats(traffic: dict) -> dict:
    """Token counts of one wave (the same for every seed)."""
    n = traffic["requests"]
    p, o = quantiles(traffic["prompt"], n), quantiles(traffic["output"], n)
    return {"requests": n, "prompt_tokens": sum(p), "output_tokens": sum(o),
            "longest_prompt": max(p), "longest_output": max(o)}


def train_batch(traffic: dict, vocab: int, seed: int, step: int, device):
    """Step ``step``'s batch: {"tokens", "targets"} (batch, seq) int32."""
    import torch

    gen = torch.Generator(device=device).manual_seed(
        int(seeded(seed, 3, step).integers(0, 2**62)))
    rows = torch.randint(0, vocab, (traffic["batch"], traffic["seq"] + 1),
                         generator=gen, device=device, dtype=torch.int64)
    return {"tokens": rows[:, :-1].to(torch.int32).contiguous(),
            "targets": rows[:, 1:].to(torch.int32).contiguous()}
