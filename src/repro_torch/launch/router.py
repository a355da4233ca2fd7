"""Cost-model-routed multi-replica serving front-end.

The paper's thesis — price work against heterogeneous platforms with a
transparent cost model instead of defaulting to one PaaS — applied to
inference replicas: latency-SLO traffic goes to premium capacity (faster,
reliable, expensive), bulk traffic to spot (cheap, preemptible).  The router
reuses the batch stack wholesale:

* ``CostEstimate`` + ``CostModel.expected_cost_with_retries`` /
  ``schedule_duration`` price each request per replica, retries and rework
  included — the same math the batch planner loads onto its timeline;
* ``OnlineCostModel.observe``/``duration_ratio`` close the loop: realized
  service times recalibrate per-(class, platform) duration predictions with
  the hierarchical EWMAs of the adaptive layer;
* per-replica ``CircuitBreaker``s (closed → open → half-open probe) stop
  routing to replicas that are hard-failing, with a single probe after
  cooldown.

A request is priced as service time = work_tokens / (tokens_per_s ·
perf_factor("serve")) scaled by the learned duration ratio, plus the
replica's current backlog delay.  Deadline feasibility uses
``schedule_duration`` (rework-aware wall-clock); cost uses
``expected_cost_with_retries`` (failures burn money).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.adaptive import CircuitBreaker, OnlineCostModel
from repro_torch.core.costmodel import CostEstimate, CostModel
from repro_torch.core.platforms import Platform, default_catalog


@dataclasses.dataclass(frozen=True)
class ServeClass:
    """Request class for pricing purposes (the 'asset' key of the EWMAs)."""
    name: str
    deadline_s: float | None  # None = bulk (throughput, min cost)

    @property
    def is_slo(self) -> bool:
        return self.deadline_s is not None


@dataclasses.dataclass
class Replica:
    """One serving replica pinned to a platform from the catalog."""
    name: str
    platform: Platform
    tokens_per_s: float  # base service rate at perf_factor 1.0
    backlog_tokens: float = 0.0

    def rate(self) -> float:
        return self.tokens_per_s * self.platform.perf_factor("serve")


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    rid: int
    replica: str
    cls: str
    estimate: CostEstimate
    expected_usd: float
    expected_wall_s: float
    deadline_feasible: bool


class ReplicaRouter:
    """Price every request against every live replica; route SLO traffic to
    the cheapest deadline-feasible replica (fastest if none is feasible) and
    bulk traffic to the cheapest overall."""

    def __init__(self, replicas: list[Replica],
                 model: OnlineCostModel | CostModel | None = None,
                 breaker_failures: int = 3, breaker_cooldown_s: float = 30.0):
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas = {r.name: r for r in replicas}
        if len(self.replicas) != len(replicas):
            raise ValueError("duplicate replica names")
        self.model = model if model is not None else OnlineCostModel()
        self.breakers = {
            r.name: CircuitBreaker(r.platform.name,
                                   failures=breaker_failures,
                                   cooldown_s=breaker_cooldown_s)
            for r in replicas
        }
        self._inflight: dict[int, RouteDecision] = {}
        self.counters = {"routed": 0, "slo_to_premium": 0, "slo_total": 0,
                         "bulk_total": 0, "slo_infeasible": 0,
                         "breaker_denials": 0, "unroutable": 0}

    # -------------------------------------------------------------- pricing
    def price(self, work_tokens: int, cls: ServeClass,
              replica: Replica) -> CostEstimate:
        """Serve-time CostEstimate for one request on one replica.

        ``compute_s`` is the pure service time (what the request is billed
        for); ``duration_s`` adds the replica's backlog delay (what the
        deadline check sees).  The learned duration ratio recalibrates the
        catalog service rate per (class, platform) cell.
        """
        plat = replica.platform
        serve_s = work_tokens / max(replica.rate(), 1e-9)
        if isinstance(self.model, OnlineCostModel):
            serve_s *= self.model.duration_ratio(cls.name, plat.name)
        wait_s = replica.backlog_tokens / max(replica.rate(), 1e-9)
        hours = serve_s / 3600.0
        base = hours * plat.chips * plat.chip_hour_usd
        surcharge = base * plat.surcharge_rate
        storage = hours * plat.chips * plat.storage_usd_per_chip_hour
        return CostEstimate(platform=plat.name, duration_s=wait_s + serve_s,
                            compute_s=serve_s, base_usd=base,
                            surcharge_usd=surcharge, storage_usd=storage)

    # -------------------------------------------------------------- routing
    def route(self, rid: int, work_tokens: int, cls: ServeClass,
              now: float = 0.0) -> RouteDecision | None:
        """Pick a replica for one request; returns None when every breaker
        is open (caller should queue and retry after the cooldown)."""
        live = [r for r in self.replicas.values()
                if self.breakers[r.name].allow(now)]
        denied = len(self.replicas) - len(live)
        self.counters["breaker_denials"] += denied
        if not live:
            self.counters["unroutable"] += 1
            return None

        scored = []
        for r in live:
            est = self.price(work_tokens, cls, r)
            usd = self.model.expected_cost_with_retries(est, r.platform,
                                                        cls.name)
            wall = self.model.schedule_duration(est, r.platform, cls.name)
            feasible = (cls.deadline_s is None or wall <= cls.deadline_s)
            scored.append((r, est, usd, wall, feasible))

        if cls.is_slo:
            self.counters["slo_total"] += 1
            feas = [s for s in scored if s[4]]
            if feas:
                r, est, usd, wall, ok = min(
                    feas, key=lambda s: (s[2], s[3], s[0].name))
            else:  # degraded: nothing meets the deadline, take the fastest
                self.counters["slo_infeasible"] += 1
                r, est, usd, wall, ok = min(
                    scored, key=lambda s: (s[3], s[2], s[0].name))
            if r.platform.kind == "premium":
                self.counters["slo_to_premium"] += 1
        else:
            self.counters["bulk_total"] += 1
            r, est, usd, wall, ok = min(
                scored, key=lambda s: (s[2], s[3], s[0].name))

        self.breakers[r.name].note_launch(now)
        r.backlog_tokens += work_tokens
        decision = RouteDecision(rid=rid, replica=r.name, cls=cls.name,
                                 estimate=est, expected_usd=usd,
                                 expected_wall_s=wall, deadline_feasible=ok)
        self._inflight[rid] = decision
        self.counters["routed"] += 1
        return decision

    def complete(self, rid: int, outcome: str, realized_s: float,
                 now: float = 0.0) -> None:
        """Fold a finished request back into the online model + breaker.
        ``outcome`` ∈ {success, failure, preemption, cancelled}."""
        d = self._inflight.pop(rid, None)
        if d is None:
            raise KeyError(f"unknown request {rid}")
        r = self.replicas[d.replica]
        r.backlog_tokens = max(
            0.0, r.backlog_tokens - d.estimate.compute_s * r.rate())
        if isinstance(self.model, OnlineCostModel):
            self.model.observe(d.cls, r.platform.name, outcome,
                               predicted_s=d.estimate.compute_s,
                               realized_s=realized_s)
        self.breakers[d.replica].record(outcome, now)

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        out = dict(self.counters)
        out["replicas"] = {
            name: {"platform": r.platform.name,
                   "backlog_tokens": r.backlog_tokens,
                   "breaker": self.breakers[name].state,
                   "trips": self.breakers[name].trips}
            for name, r in self.replicas.items()
        }
        return out


def default_replicas(tokens_per_s: float = 2000.0) -> list[Replica]:
    """A premium + spot pair from the default catalog (the Table-1 economics
    the batch planner prices against), for tests and the benchmark."""
    cat = default_catalog()
    return [
        Replica(name="premium-0", platform=cat["pod-premium"],
                tokens_per_s=tokens_per_s),
        Replica(name="spot-0", platform=cat["pod-spot"],
                tokens_per_s=tokens_per_s),
        Replica(name="spot-1", platform=cat["pod-spot"],
                tokens_per_s=tokens_per_s),
    ]
