"""Content-addressed, cross-run materialization store (the Delta-Lake-table
analogue, rebuilt for incremental materialization).

The fingerprint of a materialization is

    hash(code version, partition, upstream *data* hashes)

where the code version folds the asset's declared ``version`` string with a
hash of its compute function's source, and the upstream entries are content
hashes of the upstream *values* — not their fingerprint chains.  That buys
two properties the old version-chain store could not offer:

* **cross-run caching** — records live in a persistent, atomically rewritten
  JSON index (``<dir>/index.json``) beside content-hashed blobs
  (``<dir>/blobs/<data_hash>.pkl``), reloaded on open, so a second process
  sees the first's materializations;
* **early cutoff** — an upstream that *rematerializes byte-identical data*
  leaves its data hash unchanged, so downstream fingerprints still match and
  the downstream cone is skipped even though the upstream re-ran.

``resolve_staleness`` walks the (asset, partition) task DAG against a store
and labels every task fresh or stale with a reason (never-materialized /
code-changed / upstream-data-changed / upstream-stale / forced); the
coordinator uses it to skip fresh work up front and the planner to price
fresh tasks at ~0 (see planner.py).  A *missing* upstream record always
forces staleness — there is no placeholder hash that could masquerade as a
real one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import os
import pickle
import sys
import textwrap
import threading
import time
import warnings
from typing import TYPE_CHECKING, Any, Callable

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (assets -> store)
    from repro_torch.core.assets import AssetGraph, AssetSpec

TaskKey = tuple[str, str]  # (asset, partition)

_INDEX = "index.json"
_BLOBS = "blobs"


def _short(h: "hashlib._Hash") -> str:
    return h.hexdigest()[:16]


class StoreCorruption(UserWarning):
    """On-disk store state (index or blob) failed integrity validation."""


def _quarantine(path: str, suffix: str = "corrupt") -> str | None:
    """Move a damaged file aside as ``<path>.<suffix>-<n>`` (never clobbers
    an earlier quarantine) so post-mortems keep the evidence while the
    store carries on without it."""
    n = 0
    while True:
        target = f"{path}.{suffix}-{n}"
        if not os.path.exists(target):
            break
        n += 1
    try:
        os.replace(path, target)
    except OSError:
        return None
    return target


def _durable_write(path: str, data: bytes) -> None:
    """Crash-safe file publish: write tmp, flush+fsync, rename, fsync the
    directory.  Without the fsyncs, ``os.replace`` alone can leave a
    zero-length (or stale) file *behind the final name* after power loss —
    the rename may hit disk before the data does."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    except OSError:  # pragma: no cover - non-posix directory open
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


_source_hash_cache: dict[Callable, str] = {}


def source_hash(fn: Callable[..., Any]) -> str:
    """Stable hash of a function's source text (dedented), falling back to
    its bytecode when source is unavailable (REPL, C callables)."""
    try:
        cached = _source_hash_cache.get(fn)
    except TypeError:  # unhashable callable
        cached = None
    if cached is not None:
        return cached
    try:
        src = textwrap.dedent(inspect.getsource(fn))
    except (OSError, TypeError):
        code = getattr(fn, "__code__", None)
        src = (code.co_code.hex() + repr(code.co_consts)
               if code is not None else repr(fn))
    out = _short(hashlib.sha1(src.encode()))
    try:
        _source_hash_cache[fn] = out
    except TypeError:
        pass
    return out


def code_version(spec: "AssetSpec") -> str:
    """Asset code identity: declared version string + compute-fn source hash.
    Editing the function body or bumping ``version`` both invalidate."""
    return f"{spec.version}:{source_hash(spec.fn)}"


@dataclasses.dataclass(frozen=True)
class Staleness:
    """Resolution verdict for one (asset, partition) task."""

    fresh: bool
    reason: str  # fresh | never-materialized | code-changed |
    #             upstream-data-changed | upstream-stale:<task> |
    #             missing-upstream:<task> | forced | invalidated
    fingerprint: str = ""  # expected fingerprint ("" when unknowable)


def _holds_tensor(value: Any) -> bool:
    """True when ``value`` is, or holds in nested dicts, lists, tuples or
    sets, a ``torch.Tensor``.  torch is looked up, never imported: a
    process that has not loaded it holds no tensor."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            return True
        if isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple, set, frozenset)):
            stack.extend(v)
    return False


class MaterializationStore:
    """Content-addressed materialization records, optionally disk-backed.

    With ``directory`` set, the index is loaded on open and every ``put`` /
    ``invalidate`` atomically rewrites ``index.json`` (tmp + ``os.replace``),
    so concurrent readers never observe a torn index and a store opened
    later on the same directory sees all prior materializations.  Blobs are
    named by their content hash: identical values share one blob.
    """

    def __init__(self, directory: str | None = None):
        self.dir = directory
        self._mem: dict[TaskKey, dict] = {}
        self._lock = threading.Lock()
        self._index_mtime = 0.0
        if directory:
            os.makedirs(os.path.join(directory, _BLOBS), exist_ok=True)
            self._load_index()

    # ------------------------------------------------------------ fingerprint
    @staticmethod
    def data_fingerprint(value: Any) -> tuple[bytes, str]:
        """Pickle a value and content-hash the blob: (blob, data_hash)."""
        blob = pickle.dumps(value, protocol=4)
        return blob, _short(hashlib.sha1(blob))

    @staticmethod
    def fingerprint(code_version: str, partition: str,
                    upstream: dict[str, str]) -> str:
        """hash(code version, partition, upstream data hashes).  ``upstream``
        maps "dep[partition]" -> that materialization's ``data_hash``; a
        missing upstream has no representation here by design — callers must
        treat it as unconditionally stale instead of inventing a filler."""
        blob = json.dumps({"v": code_version, "p": partition,
                           "up": dict(sorted(upstream.items()))},
                          sort_keys=True)
        return _short(hashlib.sha1(blob.encode()))

    # ------------------------------------------------------------ index io
    def _index_path(self) -> str:
        return os.path.join(self.dir, _INDEX)

    def _load_index(self) -> None:
        """Replace in-memory records with the on-disk index (source of
        truth for disk-backed stores).

        A corrupt or truncated ``index.json`` (torn write, disk fault) must
        not brick store construction: the bad file is quarantined to
        ``index.json.corrupt-<n>`` with a warning and the store starts
        empty — the content-addressed blobs remain on disk, so identical
        re-materializations are still write-once and quarantined evidence
        survives for post-mortems."""
        path = self._index_path()
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                data = json.load(f)
            records = {(r["asset"], r["partition"]): r
                       for r in data.get("records", [])}
        except (json.JSONDecodeError, UnicodeDecodeError, KeyError,
                TypeError, OSError) as e:
            moved = _quarantine(path)
            warnings.warn(
                f"materialization index {path} is corrupt ({e!r}); "
                f"quarantined to {moved or '<unmovable>'} and starting from "
                f"the blobs that remain", StoreCorruption, stacklevel=2)
            with self._lock:
                self._mem = {}
                self._index_mtime = time.time()
            return
        with self._lock:
            self._mem = records
            self._index_mtime = os.path.getmtime(path)

    def reload(self) -> None:
        """Re-read the index from disk (cross-process refresh)."""
        if self.dir:
            self._load_index()

    def _persist_locked(self) -> None:
        """Atomic index rewrite; caller holds ``self._lock``."""
        if not self.dir:
            return
        records = [{k: v for k, v in rec.items() if k != "value"}
                   for rec in self._mem.values()]
        path = self._index_path()
        _durable_write(path, json.dumps(
            {"version": 2, "records": records}, indent=1,
            sort_keys=True).encode())
        self._index_mtime = os.path.getmtime(path)

    def _maybe_refresh(self, key: TaskKey) -> None:
        """On a record miss, pick up an index another process rewrote since
        our last load (mtime-gated so hot loops stay cheap)."""
        if not self.dir or key in self._mem:
            return
        path = self._index_path()
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return
        if mtime > self._index_mtime:
            self._load_index()

    # ------------------------------------------------------------------ api
    def put(self, asset: str, partition: str, value: Any, fingerprint: str,
            meta: dict | None = None, code_version: str = "",
            upstream: dict[str, str] | None = None) -> dict:
        if _holds_tensor(value):
            raise TypeError(
                f"{asset}[{partition}]: a stored value holds a torch.Tensor; "
                "return numpy (a card tensor would pin device memory, and "
                "its pickle hash differs from the same numbers in numpy)")
        blob, data_hash = self.data_fingerprint(value)
        rec = {
            "asset": asset, "partition": partition,
            "fingerprint": fingerprint, "data_hash": data_hash,
            "code_version": code_version,
            "upstream": dict(sorted((upstream or {}).items())),
            "time": time.time(), "meta": meta or {},
        }
        if self.dir:
            rel = os.path.join(_BLOBS, f"{data_hash}.pkl")
            path = os.path.join(self.dir, rel)
            if not os.path.exists(path):  # content-addressed: write once
                _durable_write(path, blob)
            rec["path"] = rel
        else:
            rec["value"] = value
        with self._lock:
            self._mem[(asset, partition)] = rec
            self._persist_locked()
        return rec

    def get(self, asset: str, partition: str) -> Any:
        """Load a materialized value, verifying disk bytes against the
        record's ``data_hash`` first: a corrupted or truncated blob is
        quarantined and its record dropped (demoted to never-materialized),
        so callers see a clean ``KeyError`` instead of a raw pickle error —
        or worse, silently wrong data."""
        rec = self.record(asset, partition)
        if rec is None:
            raise KeyError(f"no materialization for {asset}[{partition}]")
        if "value" in rec:
            return rec["value"]
        blob = self._read_verified(asset, partition, rec)
        if blob is None:
            raise KeyError(f"no materialization for {asset}[{partition}] "
                           f"(blob failed integrity check; quarantined)")
        return pickle.loads(blob)

    def _read_verified(self, asset: str, partition: str,
                       rec: dict) -> bytes | None:
        """Blob bytes iff they hash to the record's ``data_hash``; on any
        mismatch/IO error the blob is quarantined and the record dropped."""
        path = os.path.join(self.dir, rec["path"])
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            blob = None
        if blob is not None and \
                _short(hashlib.sha1(blob)) == rec.get("data_hash"):
            return blob
        moved = _quarantine(path) if blob is not None else None
        warnings.warn(
            f"blob for {asset}[{partition}] failed integrity check "
            f"(want data_hash {rec.get('data_hash')}); "
            f"{'quarantined to ' + moved if moved else 'unreadable'} — "
            f"record demoted to never-materialized", StoreCorruption,
            stacklevel=3)
        bad_path = rec["path"]
        with self._lock:
            doomed = [k for k, r in self._mem.items()
                      if r.get("path") == bad_path]
            for k in doomed:
                del self._mem[k]
            if doomed:
                self._persist_locked()
        return None

    def verify(self, asset: str, partition: str) -> bool:
        """True iff a record exists *and* its blob bytes match
        ``data_hash``.  Corrupt blobs are quarantined and their records
        dropped as a side effect — ``resume`` sweeps this over a run's
        cone so crash-corrupted outputs re-run instead of poisoning
        downstream tasks."""
        rec = self.record(asset, partition)
        if rec is None:
            return False
        if "value" in rec or not self.dir or "path" not in rec:
            return True
        return self._read_verified(asset, partition, rec) is not None

    def record(self, asset: str, partition: str) -> dict | None:
        key = (asset, partition)
        self._maybe_refresh(key)
        with self._lock:
            return self._mem.get(key)

    def data_hash(self, asset: str, partition: str) -> str | None:
        rec = self.record(asset, partition)
        return rec.get("data_hash") if rec else None

    def is_fresh(self, asset: str, partition: str, fingerprint: str) -> bool:
        rec = self.record(asset, partition)
        return rec is not None and rec["fingerprint"] == fingerprint

    def invalidate(self, asset: str | None = None,
                   partition: str | None = None) -> int:
        """Drop matching records from the index (blobs stay: they are
        content-addressed and may back other records).  ``None`` matches
        everything on that axis — the ``--force``/backfill escape hatch."""
        with self._lock:
            doomed = [k for k in self._mem
                      if (asset is None or k[0] == asset)
                      and (partition is None or k[1] == partition)]
            for k in doomed:
                del self._mem[k]
            if doomed:
                self._persist_locked()
        return len(doomed)

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    def __bool__(self) -> bool:
        # an empty store is still a store: never let ``store or default``
        # silently swap in a fresh one because ``len() == 0``
        return True


def resolve_staleness(graph: "AssetGraph", store: MaterializationStore,
                      targets: list[str] | None = None,
                      force: bool = False) -> dict[TaskKey, Staleness]:
    """Label every (asset, partition) task in the target cone fresh/stale.

    Walks the task DAG in topological order: a task is fresh iff every
    upstream task is fresh, every upstream record exists, and the stored
    fingerprint matches hash(current code version, partition, upstream data
    hashes).  Staleness poisons downstream pessimistically — the launch-time
    check in the coordinator still grants early cutoff when a re-run
    upstream reproduces identical data."""
    from repro_torch.core.schedule import task_dag

    keys, preds = task_dag(graph, targets)
    out: dict[TaskKey, Staleness] = {}
    cv: dict[str, str] = {}
    for tk in keys:
        name, part = tk
        if force:
            out[tk] = Staleness(False, "forced")
            continue
        stale_up = next((p for p in preds[tk] if not out[p].fresh), None)
        if stale_up is not None:
            out[tk] = Staleness(
                False, f"upstream-stale:{stale_up[0]}[{stale_up[1]}]")
            continue
        upstream: dict[str, str] = {}
        missing: TaskKey | None = None
        for (d, k) in preds[tk]:
            h = store.data_hash(d, k)
            if h is None:  # no record (or a pre-content-addressing one):
                missing = (d, k)  # never fresh — no "?" placeholder hashes
                break
            upstream[f"{d}[{k}]"] = h
        if missing is not None:
            out[tk] = Staleness(
                False, f"missing-upstream:{missing[0]}[{missing[1]}]")
            continue
        cver = cv.get(name)
        if cver is None:
            cver = cv[name] = code_version(graph[name])
        fp = MaterializationStore.fingerprint(cver, part, upstream)
        rec = store.record(name, part)
        if rec is None:
            out[tk] = Staleness(False, "never-materialized", fp)
        elif rec["fingerprint"] == fp:
            out[tk] = Staleness(True, "fresh", fp)
        elif rec.get("code_version") != cver:
            out[tk] = Staleness(False, "code-changed", fp)
        elif rec.get("upstream") != upstream:
            out[tk] = Staleness(False, "upstream-data-changed", fp)
        else:
            out[tk] = Staleness(False, "invalidated", fp)
    return out
