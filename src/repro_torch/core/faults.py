"""Seeded, deterministic fault injection for chaos-testing the run path.

``FaultPlan`` is the single knob a chaos test turns: it is threaded through
the ``RunCoordinator`` (journal-record-boundary kill points — the worst
case a real crash can produce, since the record is durable but the action
it describes may not have happened) and the ``DynamicClientFactory``
(client-level failure/slowdown overrides on named platforms), and offers
seeded on-disk corruption helpers (blob bit-flips/truncation, torn index
writes) for the ``MaterializationStore`` hardening tests.

Everything is deterministic in ``seed`` plus the target identity, so a
failing chaos run replays exactly — the same property the simulated
clients already have for task-level faults (Fig-3 reproducibility), lifted
to orchestrator-level faults.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np


class CoordinatorKilled(RuntimeError):
    """The fault plan killed the coordinator at a journal record boundary.

    In-process stand-in for SIGKILL/power loss: the coordinator loop stops
    dead (no more store writes, no more journal records), while worker
    threads it had launched are orphaned — just like a real crash leaves
    remote jobs running with nobody to collect them."""

    def __init__(self, record_seq: int):
        super().__init__(f"fault plan killed coordinator after journal "
                         f"record {record_seq}")
        self.record_seq = record_seq


@dataclasses.dataclass(frozen=True)
class ClientFaults:
    """Platform-client fault overrides (reality diverging from catalog)."""

    platforms: tuple[str, ...] = ()  # empty = every platform
    failure_rate: float | None = None
    preemption_rate: float | None = None
    slowdown: float = 1.0  # duration bias multiplier (>1 = slower)

    def applies_to(self, platform: str) -> bool:
        return not self.platforms or platform in self.platforms


@dataclasses.dataclass
class FaultPlan:
    """One reproducible chaos scenario.

    ``kill_at_record`` — raise ``CoordinatorKilled`` immediately after the
    Nth journal record (1-based) becomes durable; ``None`` disables.
    ``client`` — fault overrides applied by ``DynamicClientFactory.client``
    when building simulated platform clients.
    The ``corrupt_blob`` / ``truncate_blob`` / ``tear_index`` helpers mangle
    a store directory the way partial hardware failures do, with the byte
    positions drawn from ``seed`` so every run mangles identically.
    """

    seed: int = 0
    kill_at_record: int | None = None
    client: ClientFaults | None = None

    # ------------------------------------------------------------ kill point
    def journal_barrier(self, n_records: int) -> None:
        """Called by ``RunJournal.append`` after each durable record."""
        if self.kill_at_record is not None \
                and n_records >= self.kill_at_record:
            raise CoordinatorKilled(n_records)

    # --------------------------------------------------------------- clients
    def client_faults(self, platform: str) -> ClientFaults | None:
        if self.client is not None and self.client.applies_to(platform):
            return self.client
        return None

    # ------------------------------------------------------------------ disk
    def _rng(self, *key: object) -> np.random.RandomState:
        digest = hashlib.sha1(repr((self.seed,) + key).encode()).digest()
        return np.random.RandomState(
            int.from_bytes(digest[:4], "little") % (2 ** 31))

    def corrupt_blob(self, store_dir: str, data_hash: str) -> int:
        """Flip one seeded byte in a blob; returns the flipped offset."""
        path = os.path.join(store_dir, "blobs", f"{data_hash}.pkl")
        with open(path, "rb") as f:
            blob = bytearray(f.read())
        if not blob:
            raise ValueError(f"blob {data_hash} is empty")
        off = int(self._rng("corrupt", data_hash).randint(len(blob)))
        blob[off] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(blob))
        return off

    def truncate_blob(self, store_dir: str, data_hash: str) -> int:
        """Cut a blob to a seeded fraction of its length (torn blob write
        that dodged the tmp+rename protocol, or sector loss)."""
        path = os.path.join(store_dir, "blobs", f"{data_hash}.pkl")
        size = os.path.getsize(path)
        keep = int(self._rng("truncate", data_hash).randint(max(size, 1)))
        with open(path, "rb+") as f:
            f.truncate(keep)
        return keep

    def tear_index(self, store_dir: str) -> int:
        """Truncate ``index.json`` at a seeded offset strictly inside the
        payload — the classic torn write a non-fsync'd rename can leave
        after power loss.  Returns the kept byte count."""
        path = os.path.join(store_dir, "index.json")
        size = os.path.getsize(path)
        if size < 2:
            raise ValueError("index too small to tear")
        keep = 1 + int(self._rng("tear-index").randint(size - 1))
        with open(path, "rb+") as f:
            f.truncate(keep)
        return keep

    def tear_journal(self, journal_dir: str, run_id: str,
                     drop_bytes: int | None = None) -> int:
        """Chop seeded bytes off a journal's tail (torn final write)."""
        path = os.path.join(journal_dir, f"run-{run_id}.jsonl")
        size = os.path.getsize(path)
        drop = (drop_bytes if drop_bytes is not None
                else 1 + int(self._rng("tear-journal", run_id)
                             .randint(min(40, max(size - 1, 1)))))
        with open(path, "rb+") as f:
            f.truncate(max(size - drop, 0))
        return drop

    def describe(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str,
                          sort_keys=True)
