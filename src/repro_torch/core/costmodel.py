"""Cost & duration estimation — the decision core of the Dynamic Factory.

Duration comes from the three-term roofline (compute / memory / collective)
when the asset declares analytic work, or from calibrated chip-hours for
Table-1-style data assets; cost = duration x chips x (rate + surcharge)
+ storage, i.e. exactly the decomposition of the paper's Table 1
(Total = base + Platform Surcharge + EBS).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.assets import AssetSpec, ComputeProfile
from repro_torch.core.platforms import H100_SXM, Accelerator, Platform


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    platform: str
    duration_s: float  # wall-clock incl. startup
    compute_s: float
    base_usd: float
    surcharge_usd: float
    storage_usd: float
    feasible: bool = True
    reason: str = ""

    @property
    def total_usd(self) -> float:
        return self.base_usd + self.surcharge_usd + self.storage_usd

    @staticmethod
    def cached() -> "CostEstimate":
        """The price of work already materialized in the store: ~0 cost and
        ~0 duration on the pseudo-platform ``"cached"`` — what the planner
        assigns to fresh (asset, partition) tasks so warm-cache plans
        collapse to the stale cone (see planner.py)."""
        return CostEstimate(platform="cached", duration_s=0.0, compute_s=0.0,
                            base_usd=0.0, surcharge_usd=0.0, storage_usd=0.0)


def roofline_seconds(c: ComputeProfile, chips: int,
                     accelerator: Accelerator = H100_SXM) -> float:
    """max of the three roofline terms across the whole job."""
    if c.work_chip_hours > 0:
        return c.work_chip_hours * 3600.0 / max(1, chips)
    t_comp = c.flops / (chips * accelerator.peak_flops)
    t_mem = c.bytes_hbm / (chips * accelerator.hbm_bw)
    t_coll = c.collective_bytes / (chips * accelerator.link_bw)
    return max(t_comp, t_mem, t_coll, 1e-9)


class CostModel:
    """HBM-feasibility gate + roofline duration + Table-1 cost structure.

    Right-sizing: work-profiled assets (``work_chip_hours``) get a cluster
    sized to finish in ~``target_hours`` (the paper's "dynamic resource
    deployment with automatic scaling") — Table 1's small steps ran on small
    clusters (nodes: ~$0.40 at a rate that implies ~6 instances).  Analytic
    roofline assets (LM train/serve) always use the full mesh.

    ``accelerator`` holds the chip's peak rates and HBM size; the scalar and
    batched roofline read the same record.
    """

    def __init__(self, hbm_gb_per_chip: float | None = None,
                 target_hours: float = 0.9,
                 rework_fraction: float = 0.5,
                 accelerator: Accelerator = H100_SXM):
        self.accelerator = accelerator
        self.hbm_gb = (accelerator.hbm_gb if hbm_gb_per_chip is None
                       else hbm_gb_per_chip)
        self.target_hours = target_hours
        #: expected fraction of an attempt's duration lost when it fails or
        #: is preempted mid-run (the simulated clients inject uniform(0.2,
        #: 0.8) partial progress, mean 0.5) — drives ``schedule_duration``.
        self.rework_fraction = rework_fraction

    def _p_ok(self, platform: Platform, asset: str | None = None) -> float:
        """Single-attempt success probability used for retry/rework math.

        The base model only knows catalog beliefs; ``OnlineCostModel``
        overrides this with per-(asset, platform) observed rates.  Every
        consumer (scalar and batched) must go through this hook so the two
        paths price identically.
        """
        return platform.p_success()

    def chips_for(self, asset: AssetSpec, platform: Platform) -> int:
        c = asset.compute
        if c.work_chip_hours <= 0 or platform.kind == "local":
            return platform.chips
        perf = platform.perf_factor(c.speedup_class)
        want = int(c.work_chip_hours / (self.target_hours * perf)) + 1
        return max(c.min_chips, min(platform.chips, want))

    def estimate(self, asset: AssetSpec, platform: Platform) -> CostEstimate:
        c = asset.compute
        if platform.chips < c.min_chips:
            return CostEstimate(platform.name, float("inf"), float("inf"),
                                float("inf"), 0.0, 0.0, feasible=False,
                                reason=f"needs >= {c.min_chips} chips")
        if c.memory_gb_per_chip > self.hbm_gb and platform.kind != "local":
            return CostEstimate(platform.name, float("inf"), float("inf"),
                                float("inf"), 0.0, 0.0, feasible=False,
                                reason="exceeds HBM per chip")
        perf = platform.perf_factor(c.speedup_class)
        chips = self.chips_for(asset, platform)
        compute_s = roofline_seconds(c, chips, self.accelerator) / max(perf, 1e-9)
        duration_s = compute_s + platform.startup_s
        hours = duration_s / 3600.0
        base = hours * chips * platform.chip_hour_usd
        surcharge = base * platform.surcharge_rate
        storage = hours * chips * platform.storage_usd_per_chip_hour
        return CostEstimate(platform.name, duration_s, compute_s, base,
                            surcharge, storage)

    def expected_cost_with_retries(self, est: CostEstimate,
                                   platform: Platform,
                                   asset: str | None = None) -> float:
        """Failures burn money: E[cost] = cost / P(success) (geometric)."""
        return est.total_usd / self._p_ok(platform, asset)

    def schedule_duration(self, est: CostEstimate, platform: Platform,
                          asset: str | None = None) -> float:
        """Expected *wall-clock* duration including rework after failures
        and preemptions: the geometric retry count E[attempts] = 1/p adds
        (1/p - 1) failed attempts, each burning ``rework_fraction`` of the
        nominal duration before dying.  This is what preemption-aware
        scheduling loads onto the timeline (cost already has its own
        ``expected_cost_with_retries`` term)."""
        if not est.feasible:
            return float("inf")
        p_ok = self._p_ok(platform, asset)
        return est.duration_s * (
            1.0 + self.rework_fraction * (1.0 - p_ok) / p_ok)

    # ------------------------------------------------------ subclass hooks
    def _p_ok_col(self, platform: Platform,
                  specs: Sequence[AssetSpec]) -> np.ndarray:
        """Per-asset success probabilities on ``platform`` as a column.
        Must produce exactly the floats ``_p_ok`` returns per asset."""
        return np.full(len(specs), self._p_ok(platform))

    def _dur_ratio_col(self, platform: Platform,
                       specs: Sequence[AssetSpec]) -> np.ndarray | None:
        """Per-asset realized/predicted duration ratios (``None`` = no
        scaling).  The static model has no observations; ``OnlineCostModel``
        returns its EWMA ratios here so batched pricing sees the same
        corrections as scalar ``estimate``."""
        return None

    # ------------------------------------------------------------ batched
    def estimate_batch(self, specs: Sequence[AssetSpec],
                       platforms: Sequence[Platform]) -> dict[str, np.ndarray]:
        """Vectorized ``estimate`` + ``expected_cost_with_retries`` over all
        assets x platforms in one numpy pass.

        Returns ``[n_assets, n_platforms]`` arrays: ``duration_s``,
        ``total_usd``, ``expected_usd`` (retry-aware), ``sched_duration_s``
        (rework-aware wall clock, see ``schedule_duration``), the
        ``CostEstimate`` components (``compute_s``, ``base_usd``,
        ``surcharge_usd``, ``storage_usd``) and a boolean ``feasible`` mask
        (infeasible cells carry +inf duration/cost, zero surcharge/storage —
        same as the scalar path).  The arithmetic mirrors the scalar path op-for-op so
        batch and scalar pricing agree bit-for-bit — the planner prices
        10k-task DAGs through this instead of a per-task Python loop, and
        re-assembles per-choice ``CostEstimate`` objects from these columns
        without ever calling scalar ``estimate``.
        """
        n, m = len(specs), len(platforms)
        work = np.array([s.compute.work_chip_hours for s in specs], dtype=np.float64)
        flops = np.array([s.compute.flops for s in specs], dtype=np.float64)
        bytes_hbm = np.array([s.compute.bytes_hbm for s in specs], dtype=np.float64)
        coll = np.array([s.compute.collective_bytes for s in specs], dtype=np.float64)
        min_chips = np.array([s.compute.min_chips for s in specs], dtype=np.int64)
        mem = np.array([s.compute.memory_gb_per_chip for s in specs], dtype=np.float64)
        classes = [s.compute.speedup_class for s in specs]
        uniq = sorted(set(classes))
        cls_idx = np.array([uniq.index(c) for c in classes], dtype=np.int64)

        shape = (n, m)
        duration = np.full(shape, np.inf)
        total = np.full(shape, np.inf)
        expected = np.full(shape, np.inf)
        sched_duration = np.full(shape, np.inf)
        compute = np.full(shape, np.inf)
        base_usd = np.full(shape, np.inf)
        surcharge_usd = np.zeros(shape)
        storage_usd = np.zeros(shape)
        feasible = np.zeros(shape, dtype=bool)
        out = {"duration_s": duration, "total_usd": total,
               "expected_usd": expected, "sched_duration_s": sched_duration,
               "compute_s": compute,
               "base_usd": base_usd, "surcharge_usd": surcharge_usd,
               "storage_usd": storage_usd, "feasible": feasible}
        if n == 0:
            return out

        has_work = work > 0
        acc = self.accelerator
        for j, p in enumerate(platforms):
            ok = (p.chips >= min_chips) & (
                (mem <= self.hbm_gb) | (p.kind == "local"))
            perf = np.array([p.perf_factor(c) for c in uniq])[cls_idx]
            # chips_for: right-size work-profiled assets, full mesh otherwise
            with np.errstate(divide="ignore", invalid="ignore"):
                want = np.where(
                    has_work,
                    (work / (self.target_hours * perf)), 0.0)
            want = want.astype(np.int64) + 1
            chips = np.where(
                has_work & (p.kind != "local"),
                np.maximum(min_chips, np.minimum(p.chips, want)),
                p.chips)
            chips_f = chips.astype(np.float64)
            # roofline_seconds
            t_work = work * 3600.0 / np.maximum(1, chips_f)
            t_analytic = np.maximum.reduce([
                flops / (chips_f * acc.peak_flops),
                bytes_hbm / (chips_f * acc.hbm_bw),
                coll / (chips_f * acc.link_bw),
                np.full(n, 1e-9)])
            roof = np.where(has_work, t_work, t_analytic)
            compute_s = roof / np.maximum(perf, 1e-9)
            dur = compute_s + p.startup_s
            hours = dur / 3600.0
            base = hours * chips_f * p.chip_hour_usd
            surch = base * p.surcharge_rate
            stor = hours * chips_f * p.storage_usd_per_chip_hour
            ratio = self._dur_ratio_col(p, specs)
            if ratio is not None:
                # Mirror the scalar OnlineCostModel path: scale each
                # component, then re-sum — NOT tot * ratio, which rounds
                # differently and would break scalar/batch bit-identity.
                dur = dur * ratio
                compute_s = compute_s * ratio
                base = base * ratio
                surch = surch * ratio
                stor = stor * ratio
            tot = base + surch + stor
            pok = self._p_ok_col(p, specs)
            sched = dur * (
                1.0 + self.rework_fraction * (1.0 - pok) / pok)
            duration[:, j] = np.where(ok, dur, np.inf)
            total[:, j] = np.where(ok, tot, np.inf)
            expected[:, j] = np.where(ok, tot / pok, np.inf)
            sched_duration[:, j] = np.where(ok, sched, np.inf)
            compute[:, j] = np.where(ok, compute_s, np.inf)
            base_usd[:, j] = np.where(ok, base, np.inf)
            surcharge_usd[:, j] = np.where(ok, surch, 0.0)
            storage_usd[:, j] = np.where(ok, stor, 0.0)
            feasible[:, j] = ok
        return out
