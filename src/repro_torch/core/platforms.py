"""Execution-platform catalog.

The paper's platforms (local / EMR / Databricks) become GPU execution
environments with the same *economic* structure: a base chip-hour rate, a
platform surcharge (the DBU analogue), a runtime performance factor (the
Photon analogue), a startup latency, and a reliability profile (EMR's higher
failure rate, Fig 3).

The catalog's economic numbers -- chip counts, rates, surcharges, failure
and preemption rates, startup times, perf classes -- are the paper's Table 1
and Fig 3 calibration in relative units, shared with the reference package
so both price a plan alike.  The 0.145 base is the Table-1 calibration unit
of a chip-hour, not the price of any chip.

The hardware facts live in an ``Accelerator`` record that the cost model's
roofline reads.  ``H100_SXM`` (the default) carries datasheet figures, not
measurements.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Accelerator:
    """Per-chip peak rates for the roofline: FLOP/s at the training dtype,
    HBM bytes/s, bytes/s a direction on one chip's interconnect, and HBM
    capacity in GB."""
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    hbm_gb: float


#: NVIDIA H100 SXM5, datasheet figures: 989 TFLOP/s dense bf16, 3.35 TB/s
#: HBM3, 450 GB/s NVLink a direction, 80 GB.
H100_SXM = Accelerator(name="H100-SXM", peak_flops=989e12, hbm_bw=3.35e12,
                       link_bw=450e9, hbm_gb=80.0)

#: Photon-analogue: how much the premium runtime accelerates each workload
#: class (calibrated: Table 1 edges ~1.5x, graph/shuffle ~2.4x, light ~1.2x).
SPEEDUP_CLASSES = {
    "scan": {"premium": 1.5},
    "shuffle": {"premium": 2.4},
    "light": {"premium": 1.2},
    "train": {"premium": 1.25},
    "serve": {"premium": 1.2},
}


@dataclasses.dataclass(frozen=True)
class Platform:
    name: str
    kind: str  # local | spot | premium | multipod
    chips: int
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    chip_hour_usd: float
    surcharge_rate: float  # fraction of base compute cost (DBU analogue)
    perf_class: str = ""  # key into SPEEDUP_CLASSES factors ("" => 1.0)
    startup_s: float = 0.0
    failure_rate: float = 0.0  # P(run-level failure) per attempt
    preemption_rate: float = 0.0  # P(preemption mid-run) per attempt
    storage_usd_per_chip_hour: float = 0.0  # EBS-analogue
    perf_factor_base: float = 1.0  # generic runtime speed multiplier

    def perf_factor(self, speedup_class: str) -> float:
        extra = SPEEDUP_CLASSES.get(speedup_class, {}).get(self.kind, 1.0) \
            if self.kind == "premium" else 1.0
        return self.perf_factor_base * extra

    def effective_rate(self) -> float:
        """USD per chip-hour including surcharge."""
        return self.chip_hour_usd * (1.0 + self.surcharge_rate)

    def p_success(self) -> float:
        """Catalog belief of a single attempt succeeding (floored so the
        geometric retry expectation stays finite) — the one expression every
        retry/rework computation must share so scalar and batched pricing
        agree bit-for-bit."""
        return max(1e-3, 1.0 - self.failure_rate - self.preemption_rate)


def default_catalog() -> dict[str, Platform]:
    """Calibrated to Table 1 economics (spot ~ EMR, premium ~ DBR).  The
    multi-chip platforms are 8-GPU NVLink nodes: 32 of them, or 2 x 32."""
    base = 0.145  # Table-1 calibration unit (relative scale is what matters)
    return {
        "local": Platform(
            name="local", kind="local", chips=1, mesh_shape=(1,),
            mesh_axes=("data",), chip_hour_usd=0.0, surcharge_rate=0.0,
            perf_factor_base=0.02,  # debug-scale hardware
        ),
        "pod-spot": Platform(
            name="pod-spot", kind="spot", chips=256, mesh_shape=(32, 8),
            mesh_axes=("data", "model"), chip_hour_usd=base,
            surcharge_rate=0.26,  # EMR service-fee ratio from Table 1
            startup_s=300.0, failure_rate=0.22, preemption_rate=0.08,
            storage_usd_per_chip_hour=0.006,  # EBS: edges $13.7 @ 8.6h*256
        ),
        "pod-premium": Platform(
            name="pod-premium", kind="premium", chips=256, mesh_shape=(32, 8),
            mesh_axes=("data", "model"), chip_hour_usd=base * 2.4,
            surcharge_rate=0.48,  # DBU ratio from Table 1
            perf_class="scan", startup_s=120.0, failure_rate=0.10,
            preemption_rate=0.02, storage_usd_per_chip_hour=0.012,
        ),
        "multipod-spot": Platform(
            name="multipod-spot", kind="spot", chips=512,
            mesh_shape=(2, 32, 8), mesh_axes=("pod", "data", "model"),
            chip_hour_usd=base, surcharge_rate=0.26, startup_s=420.0,
            failure_rate=0.28, preemption_rate=0.10,
            storage_usd_per_chip_hour=0.006,
        ),
    }
