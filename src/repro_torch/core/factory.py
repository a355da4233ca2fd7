"""Dynamic Factory for Cloud Client Management (paper component #5).

"Detects and designates appropriate execution environments, adapting to
changes in processing requirements or platform preferences" — here: a
cost-model argmin over the platform catalog under a pluggable objective,
with per-asset pinning (platform_hint), deny-lists (e.g. after repeated
failures the coordinator reroutes), and client caching.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.assets import AssetSpec
from repro_torch.core.clients import (LocalClient, PlatformClient,
                                SimulatedClusterClient)
from repro_torch.core.costmodel import CostEstimate, CostModel
from repro_torch.core.faults import FaultPlan
from repro_torch.core.platforms import Platform


@dataclasses.dataclass(frozen=True)
class Objective:
    """score = expected_cost + time_value_usd_per_hour * duration.

    min_cost  -> time_value 0 (the budget-conscious EMR regime)
    min_time  -> huge time_value (the DBR regime)
    balanced  -> the paper's operating point: deadlines matter, money matters.

    ``budget_usd`` / ``deadline_s`` are *run-level* constraints: the greedy
    per-task ``choose`` cannot see them (it scores tasks in isolation), so
    they only bind through the DAG-level ``RunPlanner``, which marks a plan
    infeasible when they cannot be met.
    """

    name: str
    time_value_usd_per_hour: float
    budget_usd: float | None = None
    deadline_s: float | None = None

    @staticmethod
    def min_cost() -> "Objective":
        return Objective("min_cost", 0.0)

    @staticmethod
    def min_time() -> "Objective":
        return Objective("min_time", 1e9)

    @staticmethod
    def balanced(usd_per_hour: float = 60.0) -> "Objective":
        return Objective("balanced", usd_per_hour)

    def constrained(self, budget_usd: float | None = None,
                    deadline_s: float | None = None) -> "Objective":
        """Copy with run-level budget/deadline constraints attached."""
        return dataclasses.replace(self, budget_usd=budget_usd,
                                   deadline_s=deadline_s)


class DynamicClientFactory:
    def __init__(self, catalog: dict[str, Platform], cost_model: CostModel,
                 objective: Objective,
                 client_builder: Callable[[Platform], PlatformClient] | None = None,
                 sim_seed: int = 0, sim_time_scale: float = 0.0,
                 faults: "FaultPlan | None" = None):
        self.catalog = dict(catalog)
        self.cost_model = cost_model
        self.objective = objective
        self._clients: dict[str, PlatformClient] = {}
        self._builder = client_builder
        self.sim_seed = sim_seed
        self.sim_time_scale = sim_time_scale
        #: seeded chaos plan (core/faults.py): client-level overrides win
        #: over both the default builder and a custom ``client_builder``,
        #: so one FaultPlan degrades a platform for every consumer
        self.faults = faults

    # ----------------------------------------------------------- selection
    def estimates(self, spec: AssetSpec) -> dict[str, CostEstimate]:
        return {name: self.cost_model.estimate(spec, p)
                for name, p in self.catalog.items()}

    def score(self, spec: AssetSpec, platform: Platform) -> tuple[float, CostEstimate]:
        est = self.cost_model.estimate(spec, platform)
        if not est.feasible:
            return float("inf"), est
        exp_cost = self.cost_model.expected_cost_with_retries(
            est, platform, spec.name)
        score = exp_cost + self.objective.time_value_usd_per_hour * (
            est.duration_s / 3600.0)
        return score, est

    def choose(self, spec: AssetSpec,
               deny: set[str] | None = None) -> tuple[Platform, CostEstimate]:
        deny = deny or set()
        if spec.platform_hint and spec.platform_hint not in deny \
                and spec.platform_hint in self.catalog:
            p = self.catalog[spec.platform_hint]
            return p, self.cost_model.estimate(spec, p)
        best: tuple[float, str, CostEstimate] | None = None
        for name, p in self.catalog.items():
            if name in deny:
                continue
            s, est = self.score(spec, p)
            if best is None or s < best[0]:
                best = (s, name, est)
        if best is None or best[0] == float("inf"):
            raise RuntimeError(
                f"no feasible platform for asset {spec.name!r} (deny={deny})")
        return self.catalog[best[1]], best[2]

    # -------------------------------------------------------------- clients
    def client(self, platform: Platform) -> PlatformClient:
        if platform.name not in self._clients:
            cf = (self.faults.client_faults(platform.name)
                  if self.faults is not None else None)
            if cf is not None:
                # deterministic degraded reality for this platform: the
                # catalog's beliefs stay untouched (that gap is the point)
                self._clients[platform.name] = SimulatedClusterClient(
                    platform, seed=self.sim_seed,
                    sim_time_scale=self.sim_time_scale,
                    failure_rate=cf.failure_rate,
                    preemption_rate=cf.preemption_rate,
                    duration_bias=cf.slowdown)
            elif self._builder is not None:
                self._clients[platform.name] = self._builder(platform)
            elif platform.kind == "local":
                self._clients[platform.name] = LocalClient(platform)
            else:
                self._clients[platform.name] = SimulatedClusterClient(
                    platform, seed=self.sim_seed,
                    sim_time_scale=self.sim_time_scale)
        return self._clients[platform.name]
