"""Deterministic synthetic LM token pipeline (the port's own copy of
``repro.data.synthetic``: numpy only, and its batches are byte-identical to
the JAX package's for the same arguments).

Partition-aware (time x domain, matching the orchestrator's partitioning):
every (partition, step) pair maps to a unique, reproducible batch via a
counter-based hash — no state, so any worker can regenerate any shard after a
failure (the data-side half of fault tolerance).  The stream embeds learnable
n-gram structure (a position-mixed affine rule) so small-model training loss
decreases measurably in the examples.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _mix(x: np.ndarray) -> np.ndarray:
    # splitmix64 finalizer — counter-based, stateless (2^64 wraparound is
    # the point, so overflow warnings are silenced)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> 30)) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> 27)) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> 31)


@dataclasses.dataclass(frozen=True)
class TokenDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    partition: str = "2024-01/all"
    structure: float = 0.85  # fraction of tokens that follow the learnable rule

    def _seed(self) -> np.uint64:
        import hashlib

        # stable across processes (hash() is salted): any worker regenerates
        # any shard identically after a failure
        digest = hashlib.sha1(
            repr(("repro-data", self.partition)).encode()).digest()
        return _mix(np.uint64(int.from_bytes(digest[:8], "little")))

    def batch(self, step: int) -> dict:
        b, s, v = self.global_batch, self.seq_len, self.vocab_size
        # partition-specific active vocabulary + successor-chain structure:
        # learnable within tens of steps by tiny models (support restriction
        # + "+1 within the chain"), yet distinct per partition.
        n_active = max(4, min(32, v // 4))
        rs_part = np.random.RandomState(int(self._seed() % np.uint64(2**31)))
        active = rs_part.choice(v, size=n_active, replace=False)
        rs = np.random.RandomState(
            int((self._seed() ^ _mix(np.uint64(step + 1))) % np.uint64(2**31)))
        idx = np.zeros((b, s + 1), np.int64)
        idx[:, 0] = rs.randint(0, n_active, b)
        gate = rs.rand(b, s + 1) < self.structure
        jumps = rs.randint(0, n_active, (b, s + 1))
        for t in range(1, s + 1):
            succ = (idx[:, t - 1] + 1) % n_active
            idx[:, t] = np.where(gate[:, t], succ, jumps[:, t])
        seq = active[idx]
        tokens = seq[:, :-1].astype(np.int32)
        targets = seq[:, 1:].astype(np.int32)
        weights = np.ones((b, s), np.float32)
        return {"tokens": tokens, "targets": targets, "weights": weights}

    def batches(self, start: int, n: int):
        for i in range(start, start + n):
            yield self.batch(i)
