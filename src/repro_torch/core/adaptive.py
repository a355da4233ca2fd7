"""Closed-loop adaptive orchestration: online cost model, drift detection,
and per-platform circuit breakers.

The planner's wins assume catalog beliefs (duration, failure/preemption
rates) match reality; the paper's own Fig-3 data shows they drift.  This
module closes the loop:

- ``OnlineCostModel`` wraps the static ``CostModel`` with per-(asset,
  platform) EWMA estimates of the realized/predicted duration ratio and the
  observed single-attempt success rate, learned from ``MessageReader``
  ``COST`` events.  Both scalar ``estimate`` and vectorized
  ``estimate_batch`` apply the same corrections (via the ``_dur_ratio_col``
  / ``_p_ok_col`` hooks), so planner pricing stays bit-consistent with the
  scalar path — and with *zero* observations the model is bit-identical to
  the static one.
- ``DriftDetector`` fires when a learned duration ratio breaches the
  threshold relative to its value at the last plan, when a platform takes a
  burst of hard failures, or when preemptions streak.  Each firing hands
  ``RunCoordinator`` a reason list; the coordinator re-runs ``RunPlanner``
  over not-yet-launched tasks.
- ``CircuitBreaker`` (closed -> open after N consecutive hard failures ->
  half-open probe after a cooldown) evicts a sick platform *fleet-wide*
  through the factory deny machinery, instead of every task rediscovering
  the sickness through its own retry budget.
- ``AdaptiveController`` glues the three together behind a seq-cursor over
  the telemetry stream, with replan rate limiting.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Sequence

import numpy as np

from repro_torch.core.assets import AssetSpec
from repro_torch.core.costmodel import CostEstimate, CostModel
from repro_torch.core.factory import DynamicClientFactory
from repro_torch.core.platforms import Platform
from repro_torch.core.telemetry import MessageReader


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Tuning knobs for the closed loop (defaults are benchmark-calibrated)."""

    #: EWMA smoothing for duration ratios and success observations.
    ewma_alpha: float = 0.3
    #: pseudo-observation count of the catalog prior: with n real
    #: observations the blend weight on observed data is n / (n + prior).
    prior_strength: float = 4.0
    #: observations of an (asset, platform) cell before its ratio can
    #: trigger drift.
    min_observations: int = 3
    #: realized/predicted ratio change (vs the last plan's baseline) that
    #: counts as drift, symmetric: fire at >= x or <= 1/x.
    ratio_threshold: float = 1.4
    #: hard failures within ``burst_window`` recent outcomes on one
    #: platform that count as a failure burst.
    failure_burst: int = 3
    burst_window: int = 12
    #: consecutive preemptions on one platform that count as drift.
    preemption_streak: int = 3
    #: consecutive hard failures that trip a breaker open.
    breaker_failures: int = 3
    #: wall-clock seconds an open breaker waits before allowing a
    #: half-open probe.
    breaker_cooldown_s: float = 30.0
    #: replan rate limiting.
    max_replans: int = 8
    replan_cooldown_s: float = 0.25
    #: expected fraction of an attempt lost on failure/preemption (the
    #: simulated clients inject uniform(0.2, 0.8) partial progress).
    rework_fraction: float = 0.5
    #: learned duration ratios are clamped into this range.
    ratio_min: float = 0.05
    ratio_max: float = 20.0


class _Ewma:
    """Exponentially-weighted mean with an observation count."""

    __slots__ = ("alpha", "mean", "n")

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.mean = 0.0
        self.n = 0

    def update(self, x: float) -> None:
        self.mean = x if self.n == 0 else (
            self.alpha * x + (1.0 - self.alpha) * self.mean)
        self.n += 1


class OnlineCostModel(CostModel):
    """``CostModel`` + per-(asset, platform) corrections learned online.

    Duration: every component of a ``CostEstimate`` is scaled by the
    clamped, prior-blended EWMA of realized/predicted duration ratios.
    Reliability: ``_p_ok`` blends the catalog's ``Platform.p_success`` with
    the observed success rate (weight n / (n + prior_strength)), feeding
    both the retry-aware expected cost and the rework-aware
    ``schedule_duration``.

    Bit-consistency contract: with zero observations every output is
    bit-identical to the wrapped static model, and ``estimate_batch`` always
    equals scalar ``estimate`` cell-for-cell (the batch path scales the same
    component floats in the same order — see ``CostModel._dur_ratio_col``).
    """

    def __init__(self, base: CostModel | None = None,
                 config: AdaptiveConfig = AdaptiveConfig()):
        base = base or CostModel()
        super().__init__(hbm_gb_per_chip=base.hbm_gb,
                         target_hours=base.target_hours,
                         accelerator=base.accelerator,
                         rework_fraction=config.rework_fraction)
        self.config = config
        # hierarchical state: per-(asset, platform) cells shrink toward a
        # per-platform level, which shrinks toward the catalog prior — so
        # drift observed on one asset informs pricing of *other* assets on
        # the same platform before they ever run there
        self._ratio: dict[tuple[str, str], _Ewma] = {}
        self._ok: dict[tuple[str, str], _Ewma] = {}
        self._plat_ratio: dict[str, _Ewma] = {}
        self._plat_ok: dict[str, _Ewma] = {}

    # ------------------------------------------------------------- learning
    def observe(self, asset: str, platform: str, outcome: str,
                predicted_s: float = 0.0, realized_s: float = 0.0) -> None:
        """Fold one terminal attempt outcome into the model.  ``outcome``
        is an ``OUTCOME_KEYS`` bucket; duration ratios only learn from
        successes (failed attempts ran a partial, unknown fraction)."""
        if outcome == "cancelled":
            return
        key = (asset, platform)
        ok = self._ok.get(key)
        if ok is None:
            ok = self._ok[key] = _Ewma(self.config.ewma_alpha)
        ok.update(1.0 if outcome == "success" else 0.0)
        pok = self._plat_ok.get(platform)
        if pok is None:
            pok = self._plat_ok[platform] = _Ewma(self.config.ewma_alpha)
        pok.update(1.0 if outcome == "success" else 0.0)
        if outcome == "success" and predicted_s > 1e-6 and realized_s > 0.0:
            ratio = self._ratio.get(key)
            if ratio is None:
                ratio = self._ratio[key] = _Ewma(self.config.ewma_alpha)
            ratio.update(realized_s / predicted_s)
            pratio = self._plat_ratio.get(platform)
            if pratio is None:
                pratio = self._plat_ratio[platform] = _Ewma(
                    self.config.ewma_alpha)
            pratio.update(realized_s / predicted_s)

    def observations(self, asset: str, platform: str) -> int:
        e = self._ok.get((asset, platform))
        return e.n if e else 0

    def duration_ratio(self, asset: str | None, platform: str) -> float:
        """Hierarchically blended, clamped realized/predicted duration ratio
        for one (asset, platform) cell: catalog prior (1.0) <- platform-level
        EWMA <- cell EWMA, each shrunk by n / (n + prior_strength).  Exactly
        1.0 with no observations anywhere on the platform."""
        base = 1.0
        ep = self._plat_ratio.get(platform)
        if ep is not None and ep.n > 0:
            wp = ep.n / (ep.n + self.config.prior_strength)
            base = (1.0 - wp) * 1.0 + wp * ep.mean
        e = self._ratio.get((asset, platform)) if asset is not None else None
        if e is None or e.n == 0:
            r = base
        else:
            w = e.n / (e.n + self.config.prior_strength)
            r = (1.0 - w) * base + w * e.mean
        if r == 1.0:
            return 1.0  # keep the pristine fast path bit-exact
        return min(max(r, self.config.ratio_min), self.config.ratio_max)

    def ratios(self) -> dict[tuple[str, str], tuple[float, int]]:
        """Every learned (asset, platform) -> (blended ratio, n_obs)."""
        return {k: (self.duration_ratio(*k), e.n)
                for k, e in self._ratio.items()}

    # ------------------------------------------------------------- pricing
    def _p_ok(self, platform: Platform, asset: str | None = None) -> float:
        prior = platform.p_success()
        ep = self._plat_ok.get(platform.name)
        if ep is not None and ep.n > 0:
            wp = ep.n / (ep.n + self.config.prior_strength)
            prior = (1.0 - wp) * prior + wp * ep.mean
        e = self._ok.get((asset, platform.name)) if asset is not None else None
        if e is None or e.n == 0:
            p = prior
        else:
            w = e.n / (e.n + self.config.prior_strength)
            p = (1.0 - w) * prior + w * e.mean
        return max(1e-3, min(1.0, p))

    def _p_ok_col(self, platform: Platform,
                  specs: Sequence[AssetSpec]) -> np.ndarray:
        return np.array([self._p_ok(platform, s.name) for s in specs],
                        dtype=np.float64)

    def _dur_ratio_col(self, platform: Platform,
                       specs: Sequence[AssetSpec]) -> np.ndarray | None:
        if not self._ratio and not self._plat_ratio:
            return None  # pristine: stay byte-identical to the static path
        return np.array(
            [self.duration_ratio(s.name, platform.name) for s in specs],
            dtype=np.float64)

    def estimate(self, asset: AssetSpec, platform: Platform) -> CostEstimate:
        est = super().estimate(asset, platform)
        r = self.duration_ratio(asset.name, platform.name)
        if not est.feasible or r == 1.0:
            return est
        # scale each component (total re-derives as (base+surcharge)+storage
        # via the property) — the batch path mirrors this exactly
        return dataclasses.replace(
            est, duration_s=est.duration_s * r, compute_s=est.compute_s * r,
            base_usd=est.base_usd * r, surcharge_usd=est.surcharge_usd * r,
            storage_usd=est.storage_usd * r)


class DriftDetector:
    """Decides *when* the current plan's assumptions are stale enough to pay
    for a replan: duration-ratio breaches vs the last plan's baseline,
    hard-failure bursts, and preemption streaks (all per platform or
    per (asset, platform))."""

    def __init__(self, model: OnlineCostModel,
                 config: AdaptiveConfig = AdaptiveConfig()):
        self.model = model
        self.cfg = config
        self._baseline: dict[tuple[str, str], float] = {}
        self._recent: dict[str, deque[int]] = {}  # platform -> 1=hard failure
        self._streak: dict[str, int] = {}  # platform -> consecutive preempts

    def observe(self, asset: str, platform: str, outcome: str) -> None:
        if outcome == "cancelled":
            return
        window = self._recent.get(platform)
        if window is None:
            window = self._recent[platform] = deque(
                maxlen=self.cfg.burst_window)
        window.append(1 if outcome == "failure" else 0)
        if outcome == "preemption":
            self._streak[platform] = self._streak.get(platform, 0) + 1
        else:
            self._streak[platform] = 0

    def check(self) -> list[str]:
        """Reasons to replan right now (empty = assumptions still hold)."""
        reasons: list[str] = []
        thr = self.cfg.ratio_threshold
        for (asset, plat), (ratio, n) in sorted(self.model.ratios().items()):
            if n < self.cfg.min_observations:
                continue
            base = self._baseline.get((asset, plat), 1.0)
            rel = ratio / max(base, 1e-9)
            if rel >= thr or rel <= 1.0 / thr:
                reasons.append(f"duration drift {asset}@{plat}: "
                               f"ratio {ratio:.2f} (baseline {base:.2f})")
        for plat in sorted(self._recent):
            if sum(self._recent[plat]) >= self.cfg.failure_burst:
                reasons.append(
                    f"failure burst on {plat}: "
                    f"{sum(self._recent[plat])} hard failures in last "
                    f"{len(self._recent[plat])} outcomes")
        for plat in sorted(self._streak):
            if self._streak[plat] >= self.cfg.preemption_streak:
                reasons.append(f"preemption streak on {plat}: "
                               f"{self._streak[plat]} consecutive")
        return reasons

    def mark_replanned(self) -> None:
        """Re-baseline: the new plan already prices current beliefs, so the
        same drift must not re-trigger forever."""
        self._baseline = {k: r for k, (r, _n) in self.model.ratios().items()}
        self._recent.clear()
        self._streak.clear()


class CircuitBreaker:
    """closed -> open (after N consecutive hard failures) -> half-open
    (single probe after ``cooldown_s``) -> closed on probe success / back to
    open on probe failure.  Preemptions are neutral: expected on spot
    capacity, they neither trip nor reset the breaker."""

    def __init__(self, platform: str, failures: int = 3,
                 cooldown_s: float = 30.0):
        self.platform = platform
        self.failures = failures
        self.cooldown_s = cooldown_s
        self.state = "closed"
        self.consecutive = 0
        self.opened_at = 0.0
        self.probe_inflight = False
        self.trips = 0

    def record(self, outcome: str, now: float) -> str | None:
        """Fold a terminal outcome in; returns the new state on transition
        (``None`` when nothing changed)."""
        if outcome == "cancelled" or outcome == "preemption":
            return None
        if outcome == "success":
            self.consecutive = 0
            if self.state != "closed":
                self.state = "closed"
                self.probe_inflight = False
                return "closed"
            return None
        # hard failure
        self.consecutive += 1
        if self.state == "half-open":
            self.state = "open"
            self.opened_at = now
            self.probe_inflight = False
            self.trips += 1
            return "open"
        if self.state == "closed" and self.consecutive >= self.failures:
            self.state = "open"
            self.opened_at = now
            self.trips += 1
            return "open"
        return None

    def allow(self, now: float) -> bool:
        """May the fleet launch on this platform right now?  An open breaker
        past its cooldown flips to half-open and admits a single probe."""
        if self.state == "closed":
            return True
        if self.state == "open":
            if now - self.opened_at >= self.cooldown_s:
                self.state = "half-open"
                self.probe_inflight = False
                return True
            return False
        return not self.probe_inflight  # half-open: one probe at a time

    def note_launch(self, now: float) -> None:
        if self.state == "half-open":
            self.probe_inflight = True


class AdaptiveController:
    """Glue: consumes the telemetry stream incrementally (seq cursor),
    feeds the online model / drift detector / breakers, and rate-limits
    replan decisions for ``RunCoordinator``."""

    def __init__(self, catalog: dict[str, Platform],
                 cost_model: CostModel | None = None,
                 config: AdaptiveConfig = AdaptiveConfig()):
        self.cfg = config
        self.model = OnlineCostModel(base=cost_model, config=config)
        self.detector = DriftDetector(self.model, config)
        self.breakers = {name: CircuitBreaker(
            name, failures=config.breaker_failures,
            cooldown_s=config.breaker_cooldown_s) for name in catalog}
        self._cursor = 0
        self.replans = 0
        self._last_replan = -math.inf
        self.replan_log: list[dict] = []

    # ------------------------------------------------------------ telemetry
    def ingest(self, reader: MessageReader) -> tuple[int, list[tuple[str, str]]]:
        """Consume new events; returns (#outcomes folded in, breaker
        transitions as (platform, new_state))."""
        outcomes = 0
        transitions: list[tuple[str, str]] = []
        for e in reader.events_since(self._cursor):
            self._cursor = e.seq + 1
            if e.kind != "COST":
                continue
            outcome = e.payload.get("outcome")
            if not outcome:
                continue  # pre-adaptive emitter: nothing to learn from
            if e.payload.get("prepaid"):
                # resumed re-execution of an attempt the crashed run billed:
                # its journal BILL was already folded in by ``warm_start``
                continue
            outcomes += 1
            self.model.observe(e.asset, e.platform, outcome,
                               predicted_s=e.payload.get("est_duration_s", 0.0),
                               realized_s=e.payload.get("duration_s", 0.0))
            self.detector.observe(e.asset, e.platform, outcome)
            br = self.breakers.get(e.platform)
            if br is not None:
                t = br.record(outcome, now=e.ts)
                if t is not None:
                    transitions.append((e.platform, t))
        return outcomes, transitions

    def warm_start(self, bills: list[dict]) -> None:
        """Resume support: fold a crashed run's journaled BILL records in
        as though their COST events had been ingested live, so the
        replacement run starts with everything the dead run learned
        (duration ratios, success rates, breaker states) instead of the
        static catalog priors."""
        for b in bills:
            p = b["payload"]
            outcome = p.get("outcome")
            if not outcome:
                continue
            self.model.observe(b["asset"], b["platform"], outcome,
                               predicted_s=p.get("est_duration_s", 0.0),
                               realized_s=p.get("sim_duration_s", 0.0))
            self.detector.observe(b["asset"], b["platform"], outcome)
            br = self.breakers.get(b["platform"])
            if br is not None:
                br.record(outcome, now=b.get("ts", 0.0))

    # ------------------------------------------------------------- breakers
    def open_platforms(self, now: float) -> set[str]:
        """Platforms the fleet must not launch on right now."""
        return {name for name, b in self.breakers.items() if not b.allow(now)}

    def note_launch(self, platform: str, now: float) -> None:
        br = self.breakers.get(platform)
        if br is not None:
            br.note_launch(now)

    # -------------------------------------------------------------- replans
    def should_replan(self, now: float) -> list[str]:
        """Drift reasons if a replan is warranted *and* allowed (rate
        limits: ``max_replans`` total, ``replan_cooldown_s`` between)."""
        if self.replans >= self.cfg.max_replans:
            return []
        if now - self._last_replan < self.cfg.replan_cooldown_s:
            return []
        return self.detector.check()

    def note_replanned(self, now: float, reasons: list[str],
                       adopted: bool) -> None:
        self.replans += 1
        self._last_replan = now
        self.detector.mark_replanned()
        self.replan_log.append({"at": now, "reasons": reasons,
                                "adopted": adopted})

    # ------------------------------------------------------------- planning
    def planning_factory(self, factory: DynamicClientFactory,
                         now: float) -> DynamicClientFactory:
        """A pricing view of ``factory`` for the planner: the online cost
        model plus the catalog minus open-breaker platforms (kept whole if
        that would empty it — a sick platform beats no platform)."""
        open_p = self.open_platforms(now)
        catalog = {n: p for n, p in factory.catalog.items() if n not in open_p}
        if not catalog:
            catalog = dict(factory.catalog)
        return DynamicClientFactory(
            catalog, self.model, factory.objective,
            sim_seed=factory.sim_seed, sim_time_scale=factory.sim_time_scale)
