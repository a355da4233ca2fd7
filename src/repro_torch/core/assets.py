"""Software-defined assets + the asset graph (the Dagster layer).

An asset is a named computation with declared upstream deps, optional
partitioning, a compute profile (drives the cost model / platform choice),
a retry policy and platform hints.  ``@asset`` builds specs declaratively;
``AssetGraph`` validates the DAG and provides topological order.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable

from repro_torch.core.partitions import PartitionsDefinition


@dataclasses.dataclass(frozen=True)
class ComputeProfile:
    """Work description used by the cost model.  Either analytic roofline
    terms (flops/bytes/collective_bytes per partition-run, whole-job) or a
    calibrated ``work_chip_hours`` shortcut for non-LM assets."""

    flops: float = 0.0
    bytes_hbm: float = 0.0
    collective_bytes: float = 0.0
    work_chip_hours: float = 0.0  # pre-calibrated work (Table-1 style assets)
    speedup_class: str = "scan"  # scan | shuffle | light | train | serve
    min_chips: int = 1
    memory_gb_per_chip: float = 0.0  # feasibility gate


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3
    backoff_s: float = 0.2
    failover_after: int = 2  # attempts on the chosen platform before rerouting
    backoff_cap_s: float = 30.0  # ceiling for the exponential schedule
    jitter: float = 0.25  # +/- fraction of the delay, deterministic per task

    def delay_s(self, attempt: int, key: tuple[str, str] = ("", "")) -> float:
        """Backoff before retry number ``attempt`` (1-based): capped
        exponential ``backoff_s * 2**(attempt-1)`` with deterministic jitter
        derived from ``key`` (asset, partition) — no RNG state, so reruns and
        tests reproduce the exact eligibility schedule while distinct tasks
        retrying after the same platform hiccup decorrelate instead of
        stampeding back together."""
        if self.backoff_s <= 0.0:
            return 0.0
        base = min(self.backoff_s * (2.0 ** max(0, attempt - 1)),
                   self.backoff_cap_s)
        if self.jitter <= 0.0:
            return base
        # blake2b is stable across processes (unlike hash()), cheap, and
        # keyed only by task identity + attempt so a given retry always
        # lands at the same offset in [-jitter, +jitter].
        digest = hashlib.blake2b(
            f"{key[0]}|{key[1]}|{attempt}".encode(), digest_size=8).digest()
        unit = int.from_bytes(digest, "big") / float(2 ** 64)  # [0, 1)
        return base * (1.0 + self.jitter * (2.0 * unit - 1.0))


@dataclasses.dataclass(frozen=True)
class AssetSpec:
    name: str
    fn: Callable[..., Any]
    deps: tuple[str, ...] = ()
    partitions: PartitionsDefinition | None = None
    compute: ComputeProfile = ComputeProfile()
    retry: RetryPolicy = RetryPolicy()
    platform_hint: str | None = None  # pin to a platform (overrides factory)
    tags: tuple[tuple[str, str], ...] = ()
    version: str = "1"  # bump to invalidate cached materializations


def asset(name: str | None = None, deps: tuple[str, ...] = (),
          partitions: PartitionsDefinition | None = None,
          compute: ComputeProfile | None = None,
          retry: RetryPolicy | None = None,
          platform_hint: str | None = None,
          tags: dict[str, str] | None = None,
          version: str = "1"):
    """Decorator: ``fn(ctx, **dep_values) -> value``."""

    def deco(fn: Callable[..., Any]) -> AssetSpec:
        return AssetSpec(
            name=name or fn.__name__,
            fn=fn,
            deps=tuple(deps),
            partitions=partitions,
            compute=compute or ComputeProfile(),
            retry=retry or RetryPolicy(),
            platform_hint=platform_hint,
            tags=tuple(sorted((tags or {}).items())),
            version=version,
        )

    return deco


class AssetGraph:
    def __init__(self, assets: list[AssetSpec] | None = None):
        self._assets: dict[str, AssetSpec] = {}
        # reverse adjacency (producer -> consumers), maintained on add() so
        # downstream() never rescans the whole asset table
        self._children: dict[str, list[str]] = {}
        for a in assets or []:
            self.add(a)

    def add(self, spec: AssetSpec) -> AssetSpec:
        if spec.name in self._assets:
            raise ValueError(f"duplicate asset {spec.name!r}")
        self._assets[spec.name] = spec
        for d in spec.deps:
            self._children.setdefault(d, []).append(spec.name)
        return spec

    def __getitem__(self, name: str) -> AssetSpec:
        return self._assets[name]

    def __contains__(self, name: str) -> bool:
        return name in self._assets

    def names(self) -> list[str]:
        return list(self._assets)

    def validate(self) -> None:
        for a in self._assets.values():
            for d in a.deps:
                if d not in self._assets:
                    raise ValueError(f"asset {a.name!r} depends on unknown {d!r}")
        self.topo_order()  # raises on cycles

    def topo_order(self, targets: list[str] | None = None) -> list[str]:
        """Kahn topological order restricted to targets + their ancestors."""
        want = set(targets or self._assets)
        frontier = list(want)
        while frontier:
            n = frontier.pop()
            for d in self._assets[n].deps:
                if d not in want:
                    want.add(d)
                    frontier.append(d)
        indeg = {n: 0 for n in want}
        out: dict[str, list[str]] = {n: [] for n in want}
        for n in want:
            for d in self._assets[n].deps:
                indeg[n] += 1
                out[d].append(n)
        ready = sorted(n for n, k in indeg.items() if k == 0)
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for m in sorted(out[n]):
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(want):
            cyc = sorted(set(want) - set(order))
            raise ValueError(f"cycle detected among {cyc}")
        return order

    def children(self, name: str) -> tuple[str, ...]:
        """Direct consumers of ``name`` (memoized reverse edges)."""
        return tuple(self._children.get(name, ()))

    def downstream(self, name: str) -> set[str]:
        """Transitive consumers of ``name`` (excluding ``name``), via the
        memoized reverse adjacency — iterative, O(edges in the cone), where
        the old recursive version rescanned every asset per call (quadratic
        on deep graphs)."""
        out: set[str] = set()
        stack = [name]
        while stack:
            for c in self._children.get(stack.pop(), ()):
                if c not in out:
                    out.add(c)
                    stack.append(c)
        return out

    def upstream(self, name: str) -> set[str]:
        """Transitive producers of ``name`` (excluding ``name``)."""
        out: set[str] = set()
        stack = [name]
        while stack:
            for d in self._assets[stack.pop()].deps:
                if d not in out:
                    out.add(d)
                    stack.append(d)
        return out
