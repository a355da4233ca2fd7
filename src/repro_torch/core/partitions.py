"""Partitioning: time-window x static-domain, matching the paper's scheme
("data is partitioned along two primary dimensions: time and domain").

Keys are strings; multi-partition keys join dimensions with '/'.
"""
from __future__ import annotations

import dataclasses
import itertools


class PartitionsDefinition:
    def keys(self) -> list[str]:
        raise NotImplementedError

    def __contains__(self, key: str) -> bool:
        return key in self.keys()

    def __len__(self) -> int:
        return len(self.keys())


@dataclasses.dataclass(frozen=True)
class StaticPartitions(PartitionsDefinition):
    names: tuple[str, ...]

    def keys(self) -> list[str]:
        return list(self.names)


@dataclasses.dataclass(frozen=True)
class TimeWindowPartitions(PartitionsDefinition):
    """Monthly windows like Common Crawl CC-MAIN snapshots."""

    start: str  # "2023-10"
    end: str  # "2024-03" inclusive

    def keys(self) -> list[str]:
        # memoized via __dict__ (bypasses the frozen-dataclass setattr
        # guard): key expansion is hot in staleness resolution and task-DAG
        # builds, and the fields are immutable
        cached = self.__dict__.get("_keys")
        if cached is None:
            y0, m0 = map(int, self.start.split("-"))
            y1, m1 = map(int, self.end.split("-"))
            out = []
            y, m = y0, m0
            while (y, m) <= (y1, m1):
                out.append(f"{y:04d}-{m:02d}")
                m += 1
                if m > 12:
                    y, m = y + 1, 1
            cached = self.__dict__["_keys"] = out
        return list(cached)

    @staticmethod
    def of(*keys: str) -> "StaticPartitions":
        return StaticPartitions(tuple(keys))


@dataclasses.dataclass(frozen=True)
class MultiPartitions(PartitionsDefinition):
    """Cross-product, e.g. crawl-month x domain-shard."""

    dims: tuple[tuple[str, PartitionsDefinition], ...]

    def keys(self) -> list[str]:
        cached = self.__dict__.get("_keys")
        if cached is None:
            parts = [d.keys() for _, d in self.dims]
            cached = self.__dict__["_keys"] = [
                "/".join(combo) for combo in itertools.product(*parts)]
        return list(cached)

    def split(self, key: str) -> dict[str, str]:
        vals = key.split("/")
        assert len(vals) == len(self.dims), (key, self.dims)
        return {name: v for (name, _), v in zip(self.dims, vals)}


def partition_keys(p: PartitionsDefinition | None) -> list[str]:
    """None => a single unpartitioned pseudo-key."""
    return p.keys() if p is not None else ["__all__"]


def dep_partition_keys(dep: PartitionsDefinition | None,
                       partition: str,
                       dkeys: list[str] | None = None) -> list[str]:
    """Which upstream partitions a task with ``partition`` consumes: the
    matching key when partitionings align, every key on fan-in.

    ``dkeys`` lets hot callers (``schedule.task_dag`` expands 10k-task DAGs)
    pass the upstream's already-expanded ``partition_keys`` so it is not
    recomputed per task; semantics are identical."""
    if dkeys is None:
        dkeys = partition_keys(dep)
    if partition in dkeys:
        return [partition]
    if dkeys == ["__all__"]:
        return ["__all__"]
    return dkeys  # fan-in: downstream consumes every upstream partition
