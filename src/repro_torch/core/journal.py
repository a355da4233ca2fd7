"""Write-ahead run journal: crash-consistent durability for the coordinator.

The paper's cost wins come from leaning on cheap, preemptible capacity —
which only pays off if a *run* survives the orchestrator itself dying, not
just individual task failures.  ``RunJournal`` is an append-only JSONL log
(one file per run) that the ``RunCoordinator`` writes at every task
lifecycle transition:

    BEGIN    run opened: targets, objective, force/cache flags
    LAUNCH   an attempt submitted to a platform (incl. speculative twins)
    BILL     an attempt's terminal money record (outcome rides along)
    SUCCESS  a materialization landed in the store (after ``put``)
    REPLAN   the adaptive loop adopted/rejected a mid-run replan
    RESUME   a crashed run was reopened by ``RunCoordinator.resume``
    FAIL     a task exhausted its retry budget (the run is about to raise)
    END      the run returned (ok flag)

Durability contract: every record is fsync'd before the coordinator acts on
it, each line carries a checksum of its own payload, and replay tolerates a
torn tail (a crash mid-write loses at most the record being written, never
the prefix).  Records are idempotency-keyed per (run, asset, partition,
attempt, platform), so ``resume`` can reconstruct exactly which attempts
were billed, which were in flight, and which materializations landed —
and never bill the same attempt twice.

``JournalState`` is the replayed view: billed attempts, launched-but-
unbilled frontier, landed materializations, money spent, and the adaptive
observations (BILL records double as ``OnlineCostModel`` training data, so
a resumed run carries forward everything the crashed run learned).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import warnings
from typing import IO, Any

TaskKey = tuple[str, str]  # (asset, partition)

#: record kinds a journal may contain (anything else fails validation)
KINDS = ("BEGIN", "LAUNCH", "BILL", "SUCCESS", "REPLAN", "RESUME",
         "FAIL", "END")


class JournalCorruption(UserWarning):
    """A journal line failed checksum/parse validation during replay."""


def _crc(body: str) -> str:
    return hashlib.sha1(body.encode()).hexdigest()[:8]


def _fsync_dir(path: str) -> None:
    """fsync a directory so a freshly created file survives power loss
    (no-op on platforms without O_RDONLY dir opens)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - non-posix
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class RunJournal:
    """Append-only, checksummed, fsync'd JSONL write-ahead log for one run.

    Each line is ``json.dumps(record, sort_keys=True)`` where
    ``record["crc"]`` is a checksum of the record *without* the crc field —
    a torn write (partial line, bit flip) is detected on replay instead of
    being parsed as garbage.  ``faults`` (a ``FaultPlan``) gets a
    ``journal_barrier`` callback after every durable append: the seeded
    chaos harness kills the coordinator at exact record boundaries, which
    is the worst case a real crash can produce (the record is durable, the
    action it describes may not have happened yet — or vice versa).
    """

    def __init__(self, directory: str, run_id: str, fsync: bool = True,
                 faults: "Any | None" = None):
        self.dir = directory
        self.run_id = run_id
        self.fsync = fsync
        self.faults = faults
        os.makedirs(directory, exist_ok=True)
        self.path = self.path_for(directory, run_id)
        existed = os.path.exists(self.path)
        self._f: IO[str] = open(self.path, "a")
        if not existed and fsync:
            _fsync_dir(directory)
        self._seq = self._count_existing()

    @staticmethod
    def path_for(directory: str, run_id: str) -> str:
        return os.path.join(directory, f"run-{run_id}.jsonl")

    def _count_existing(self) -> int:
        if self._f.tell() == 0:
            return 0
        records, _ = self.load(self.dir, self.run_id)
        return records[-1]["seq"] + 1 if records else 0

    # ------------------------------------------------------------------ write
    def append(self, kind: str, asset: str = "", partition: str = "",
               platform: str = "", attempt: int = 0, **payload: Any) -> dict:
        """Durably append one record and return it.  The fault barrier runs
        *after* the fsync: a chaos kill at record N leaves records 1..N on
        disk — exactly the state a power loss right after the write leaves.
        """
        if kind not in KINDS:
            raise ValueError(f"unknown journal record kind {kind!r}")
        rec = {"seq": self._seq, "ts": time.time(), "run": self.run_id,
               "kind": kind, "asset": asset, "partition": partition,
               "platform": platform, "attempt": attempt, "payload": payload}
        rec["crc"] = _crc(json.dumps(rec, sort_keys=True))
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._seq += 1
        if self.faults is not None:
            self.faults.journal_barrier(self._seq)
        return rec

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:  # pragma: no cover
            pass

    # ------------------------------------------------------------------- read
    @staticmethod
    def exists(directory: str, run_id: str) -> bool:
        return os.path.exists(RunJournal.path_for(directory, run_id))

    @staticmethod
    def load(directory: str, run_id: str) -> tuple[list[dict], int]:
        """Replay a journal file: returns (valid records, #dropped lines).

        Replay is torn-tail-tolerant: the first line that fails to parse or
        checksum ends the replay (everything after it is untrustworthy —
        with fsync'd appends that can only be a torn final write).  A
        mid-file corruption therefore also truncates the trusted prefix,
        which is the conservative reading: resume re-does work rather than
        trusting a record whose neighbours were mangled."""
        path = RunJournal.path_for(directory, run_id)
        records: list[dict] = []
        dropped = 0
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            return [], 0
        for i, line in enumerate(lines):
            rec = RunJournal._validate_line(line)
            if rec is None or (records and rec["seq"] != records[-1]["seq"] + 1):
                dropped = len(lines) - i
                warnings.warn(
                    f"journal {os.path.basename(path)}: line {i + 1} failed "
                    f"validation; dropping it and the {dropped - 1} records "
                    f"after it (torn tail / corruption)", JournalCorruption,
                    stacklevel=2)
                break
            records.append(rec)
        return records, dropped

    @staticmethod
    def _validate_line(line: str) -> dict | None:
        line = line.strip()
        if not line:
            return None
        try:
            rec = json.loads(line)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return None
        if not isinstance(rec, dict) or "crc" not in rec:
            return None
        crc = rec.pop("crc")
        if _crc(json.dumps(rec, sort_keys=True)) != crc:
            return None
        if rec.get("kind") not in KINDS or "seq" not in rec:
            return None
        rec["crc"] = crc
        return rec


@dataclasses.dataclass
class JournalState:
    """Replayed run state — what ``resume`` reconciles against the store.

    ``bills`` is ordered by seq and doubles as the adaptive warm-start
    stream (each BILL carries outcome / realized / predicted duration).
    """

    run_id: str
    targets: list[str] | None
    force: bool
    planned: bool
    use_cache: bool
    objective: dict[str, Any]
    launches: dict[TaskKey, list[dict]]
    bills: list[dict]
    bills_by_task: dict[TaskKey, list[dict]]
    succeeded: dict[TaskKey, dict]
    failed: set[TaskKey]
    replans: int
    resumes: int
    ended: bool
    ok: bool | None
    dropped_records: int
    last_seq: int

    @classmethod
    def from_records(cls, records: list[dict],
                     dropped: int = 0) -> "JournalState":
        if not records or records[0]["kind"] != "BEGIN":
            raise ValueError("journal has no BEGIN record (empty or torn "
                             "at birth) — nothing to resume")
        begin = records[0]["payload"]
        st = cls(run_id=records[0]["run"],
                 targets=begin.get("targets"),
                 force=bool(begin.get("force", False)),
                 planned=bool(begin.get("planned", False)),
                 use_cache=bool(begin.get("use_cache", True)),
                 objective=begin.get("objective", {}),
                 launches={}, bills=[], bills_by_task={}, succeeded={},
                 failed=set(), replans=0, resumes=0, ended=False, ok=None,
                 dropped_records=dropped, last_seq=records[-1]["seq"])
        for r in records:
            tk = (r["asset"], r["partition"])
            kind = r["kind"]
            if kind == "LAUNCH":
                st.launches.setdefault(tk, []).append(r)
            elif kind == "BILL":
                st.bills.append(r)
                st.bills_by_task.setdefault(tk, []).append(r)
            elif kind == "SUCCESS":
                st.succeeded[tk] = r
            elif kind == "FAIL":
                st.failed.add(tk)
            elif kind == "REPLAN":
                st.replans += 1
            elif kind == "RESUME":
                st.resumes += 1
                st.ended, st.ok = False, None  # the run is live again
            elif kind == "END":
                st.ended = True
                st.ok = bool(r["payload"].get("ok", False))
        return st

    # ------------------------------------------------------------- accounting
    @staticmethod
    def bill_key(rec: dict) -> tuple:
        """Idempotency key: one bill per (task, attempt, platform, twin?)."""
        return (rec["asset"], rec["partition"], rec["attempt"],
                rec["platform"], bool(rec["payload"].get("speculative")))

    def billed_keys(self) -> list[tuple]:
        return [self.bill_key(b) for b in self.bills]

    def spent_usd(self) -> float:
        return sum(b["payload"].get("cost_usd", 0.0) for b in self.bills)

    def terminal_attempts(self, tk: TaskKey) -> set[int]:
        """Attempt numbers with a non-speculative terminal bill."""
        return {b["attempt"] for b in self.bills_by_task.get(tk, [])
                if not b["payload"].get("speculative")}

    def in_flight(self) -> dict[TaskKey, list[dict]]:
        """Non-speculative LAUNCH records with no terminal bill for the same
        attempt — the attempts the crash cut down mid-air."""
        out: dict[TaskKey, list[dict]] = {}
        for tk, launches in self.launches.items():
            term = self.terminal_attempts(tk)
            orphans = [r for r in launches
                       if not r["payload"].get("speculative")
                       and r["attempt"] not in term]
            if orphans:
                out[tk] = orphans
        return out

    def frontier(self) -> set[TaskKey]:
        """Task keys whose work may need re-execution on resume: attempts
        in flight at the crash, plus success-billed attempts whose
        materialization never landed (crash between BILL and store put).
        Everything else is either durably done or durably failed-and-
        retryable exactly where the journal says."""
        out = set(self.in_flight())
        for tk, bills in self.bills_by_task.items():
            if tk in self.succeeded:
                continue
            # speculative counts too: a twin that won was success-billed
            # under the twin flag, and its put may equally have been lost
            if any(b["payload"].get("outcome") == "success" for b in bills):
                out.add(tk)
        return out

    def summary(self) -> str:
        lines = [f"run {self.run_id}: {len(self.succeeded)} landed, "
                 f"{len(self.bills)} bills (${self.spent_usd():.2f}), "
                 f"{len(self.frontier())} frontier task(s), "
                 f"replans={self.replans} resumes={self.resumes} "
                 f"ended={self.ended} ok={self.ok}"]
        if self.dropped_records:
            lines.append(f"  dropped {self.dropped_records} torn/corrupt "
                         f"journal record(s)")
        for tk, launches in sorted(self.in_flight().items()):
            atts = sorted(r["attempt"] for r in launches)
            lines.append(f"  in-flight {tk[0]}[{tk[1]}] attempt(s) {atts}")
        return "\n".join(lines)
