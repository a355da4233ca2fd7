"""Unified asset selection — one expression surface for planner,
coordinator and CLI.

``RunCoordinator.plan()`` / ``materialize()`` and ``launch/dryrun.py`` used
to accept a stringly-typed ``targets: list[str] | None`` with slightly
different behavior at each call site.  ``AssetSelection`` replaces that with
a small composable expression type resolved against an ``AssetGraph``:

    AssetSelection.assets("edges")                  # explicit names
    AssetSelection.assets("nodes").downstream()     # nodes + its consumers
    AssetSelection.tag("team", "crawl")             # tag filter
    AssetSelection.group("ingest") | AssetSelection.assets("report")
    (sel_a & sel_b) - AssetSelection.assets("scratch")

``parse`` accepts the CLI syntax used by ``dryrun --select``:

    "edges"           that asset
    "nodes+"          the asset and its downstream closure (backfill cone)
    "+graph"          the asset and its upstream closure
    "+graph+"         both closures
    "tag:team=crawl"  tag filter (value optional: "tag:team")
    "group:ingest"    group filter (sugar for tag:group=<name>)
    "*"               everything
    "a,b+,tag:x=y"    comma/whitespace-separated clauses union

``coerce`` keeps every legacy call site working: ``None`` selects all,
``list[str]`` selects those names, a string goes through ``parse``, and an
``AssetSelection`` passes through — so planner, coordinator and CLI agree
on one selection surface.
"""
from __future__ import annotations

import dataclasses
import re
from typing import TYPE_CHECKING, Iterable

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.assets import AssetGraph

_CLAUSE = re.compile(r"^(?P<up>\+?)(?P<body>[^+\s]+)(?P<down>\+?)$")


class AssetSelection:
    """Composable selection expression; build via the static factories and
    combine with ``|`` (union), ``&`` (intersection), ``-`` (difference)."""

    # ------------------------------------------------------------ factories
    @staticmethod
    def all() -> "AssetSelection":
        return _All()

    @staticmethod
    def assets(*names: str) -> "AssetSelection":
        return _Keys(tuple(names))

    @staticmethod
    def tag(key: str, value: str | None = None) -> "AssetSelection":
        return _Tag(key, value)

    @staticmethod
    def group(name: str) -> "AssetSelection":
        """Sugar for the conventional ``group`` tag."""
        return _Tag("group", name)

    # ---------------------------------------------------------- combinators
    def __or__(self, other: "AssetSelection") -> "AssetSelection":
        return _Binary("|", self, other)

    def __and__(self, other: "AssetSelection") -> "AssetSelection":
        return _Binary("&", self, other)

    def __sub__(self, other: "AssetSelection") -> "AssetSelection":
        return _Binary("-", self, other)

    def upstream(self, include_self: bool = True) -> "AssetSelection":
        """Transitive producers of the selected assets."""
        return _Closure(self, "up", include_self)

    def downstream(self, include_self: bool = True) -> "AssetSelection":
        """Transitive consumers of the selected assets (backfill cone)."""
        return _Closure(self, "down", include_self)

    # ------------------------------------------------------------ resolution
    def resolve(self, graph: "AssetGraph") -> list[str]:
        """Asset names selected by this expression, sorted.  Unknown
        explicit names raise with the available catalog."""
        return sorted(self._resolve(graph))

    def _resolve(self, graph: "AssetGraph") -> set[str]:
        raise NotImplementedError

    # --------------------------------------------------------------- parsing
    @staticmethod
    def parse(text: str) -> "AssetSelection":
        """Parse the CLI selection syntax (see module docstring)."""
        clauses = [c for c in re.split(r"[,\s]+", text.strip()) if c]
        if not clauses:
            raise ValueError("empty selection expression")
        out: AssetSelection | None = None
        for clause in clauses:
            out = AssetSelection._parse_clause(clause) if out is None \
                else out | AssetSelection._parse_clause(clause)
        return out

    @staticmethod
    def _parse_clause(clause: str) -> "AssetSelection":
        if clause == "*":
            return _All()
        m = _CLAUSE.match(clause)
        if not m:
            raise ValueError(f"bad selection clause {clause!r}")
        body = m.group("body")
        if body.startswith("tag:"):
            key, _, value = body[4:].partition("=")
            sel: AssetSelection = _Tag(key, value or None)
        elif body.startswith("group:"):
            sel = _Tag("group", body[6:])
        else:
            sel = _Keys((body,))
        # "+name+" means upstream-cone UNION downstream-cone of the base
        # selection, not the downstream closure of the upstream closure
        if m.group("up") and m.group("down"):
            return sel.upstream() | sel.downstream()
        if m.group("up"):
            return sel.upstream()
        if m.group("down"):
            return sel.downstream()
        return sel

    @staticmethod
    def coerce(obj: "AssetSelection | str | Iterable[str] | None",
               ) -> "AssetSelection":
        """Normalize every legacy ``targets`` spelling to a selection."""
        if obj is None:
            return _All()
        if isinstance(obj, AssetSelection):
            return obj
        if isinstance(obj, str):
            return AssetSelection.parse(obj)
        if isinstance(obj, (list, tuple, set, frozenset)):
            names = tuple(obj)
            if not all(isinstance(n, str) for n in names):
                raise TypeError(f"asset names must be strings: {names!r}")
            return _All() if not names else _Keys(names)
        raise TypeError(f"cannot coerce {type(obj).__name__!r} "
                        f"to an AssetSelection")


@dataclasses.dataclass(frozen=True)
class _All(AssetSelection):
    def _resolve(self, graph: "AssetGraph") -> set[str]:
        return set(graph.names())

    def __repr__(self) -> str:
        return "AssetSelection.all()"


@dataclasses.dataclass(frozen=True)
class _Keys(AssetSelection):
    names: tuple[str, ...]

    def _resolve(self, graph: "AssetGraph") -> set[str]:
        unknown = [n for n in self.names if n not in graph]
        if unknown:
            raise ValueError(
                f"unknown asset(s) {unknown} — available: "
                f"{sorted(graph.names())}")
        return set(self.names)

    def __repr__(self) -> str:
        return f"AssetSelection.assets({', '.join(map(repr, self.names))})"


@dataclasses.dataclass(frozen=True)
class _Tag(AssetSelection):
    key: str
    value: str | None = None

    def _resolve(self, graph: "AssetGraph") -> set[str]:
        out = set()
        for name in graph.names():
            for k, v in graph[name].tags:
                if k == self.key and (self.value is None or v == self.value):
                    out.add(name)
                    break
        return out

    def __repr__(self) -> str:
        val = "" if self.value is None else f", {self.value!r}"
        return f"AssetSelection.tag({self.key!r}{val})"


@dataclasses.dataclass(frozen=True)
class _Closure(AssetSelection):
    child: AssetSelection
    direction: str  # "up" | "down"
    include_self: bool = True

    def _resolve(self, graph: "AssetGraph") -> set[str]:
        base = self.child._resolve(graph)
        out = set(base) if self.include_self else set()
        walk = graph.upstream if self.direction == "up" else graph.downstream
        for name in base:
            out |= walk(name)
        return out

    def __repr__(self) -> str:
        op = "upstream" if self.direction == "up" else "downstream"
        return f"{self.child!r}.{op}()"


@dataclasses.dataclass(frozen=True)
class _Binary(AssetSelection):
    op: str  # "|" | "&" | "-"
    left: AssetSelection
    right: AssetSelection

    def _resolve(self, graph: "AssetGraph") -> set[str]:
        a, b = self.left._resolve(graph), self.right._resolve(graph)
        if self.op == "|":
            return a | b
        if self.op == "&":
            return a & b
        return a - b

    def __repr__(self) -> str:
        return f"({self.left!r} {self.op} {self.right!r})"
