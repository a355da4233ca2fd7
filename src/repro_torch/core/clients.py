"""Generic platform clients (paper components #3/#4): one protocol, multiple
execution environments.

``LocalClient`` executes in-process (the rapid-prototyping path the paper
emphasizes).  ``SimulatedClusterClient`` *really executes* the asset function
(everything in this container runs on local devices) while modelling the
platform's economics and reliability: simulated wall-clock from the cost
model, per-attempt failure/preemption injection with a deterministic RNG —
this is what makes the Fig-3 reliability study reproducible.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from typing import Any, Callable

import numpy as np

from repro_torch.core.costmodel import CostEstimate
from repro_torch.core.context import RunContext
from repro_torch.core.platforms import Platform


class PlatformError(RuntimeError):
    def __init__(self, msg: str, kind: str = "failure"):
        super().__init__(msg)
        self.kind = kind  # failure | preemption


@dataclasses.dataclass
class JobSpec:
    fn: Callable[..., Any]
    args: tuple
    kwargs: dict
    ctx: RunContext
    estimate: CostEstimate


@dataclasses.dataclass
class RunHandle:
    job_id: str
    platform: str
    thread: threading.Thread | None = None
    result: Any = None
    error: Exception | None = None
    cancelled: bool = False
    started: float = 0.0
    finished: float = 0.0
    sim_duration_s: float = 0.0

    def done(self) -> bool:
        return self.thread is None or not self.thread.is_alive()


class PlatformClient:
    """Protocol: submit / poll / cancel / logs."""

    platform: Platform

    def submit(self, job: JobSpec) -> RunHandle:
        raise NotImplementedError

    def poll(self, h: RunHandle, timeout: float | None = None) -> RunHandle:
        if h.thread is not None:
            h.thread.join(timeout)
        return h

    def cancel(self, h: RunHandle) -> None:
        h.cancelled = True

    def logs(self, h: RunHandle) -> str:
        state = ("cancelled" if h.cancelled else
                 "error" if h.error else
                 "done" if h.done() else "running")
        return f"[{self.platform.name}] job {h.job_id}: {state}"


class LocalClient(PlatformClient):
    def __init__(self, platform: Platform):
        self.platform = platform

    def submit(self, job: JobSpec) -> RunHandle:
        h = RunHandle(job_id=uuid.uuid4().hex[:12], platform=self.platform.name)

        def run():
            h.started = time.time()
            try:
                h.result = job.fn(job.ctx, *job.args, **job.kwargs)
            except Exception as e:  # surfaced via poll
                h.error = e
            h.finished = time.time()
            h.sim_duration_s = h.finished - h.started

        h.thread = threading.Thread(target=run, daemon=True)
        h.thread.start()
        return h


class SimulatedClusterClient(PlatformClient):
    """Real execution + simulated platform economics and reliability.

    Fault injection is deterministic in (run_id, asset, partition, attempt),
    so reliability experiments replay exactly.
    """

    def __init__(self, platform: Platform, seed: int = 0,
                 sim_time_scale: float = 0.0,
                 failure_rate: float | None = None,
                 preemption_rate: float | None = None,
                 duration_bias: float = 1.0):
        self.platform = platform
        self.seed = seed
        #: 0.0 => don't sleep at all (pure accounting); >0 => sleep
        #: sim_duration * scale to exercise real concurrency/stragglers.
        self.sim_time_scale = sim_time_scale
        #: *actual* reliability may diverge from the catalog's belief —
        #: that gap is what retries/failover/speculation exist for.
        self.failure_rate = (platform.failure_rate if failure_rate is None
                             else failure_rate)
        self.preemption_rate = (platform.preemption_rate
                                if preemption_rate is None else preemption_rate)
        #: straggling: > 1; may be a callable RunContext -> float so tests
        #: and chaos experiments can straggle specific partitions.
        self.duration_bias = duration_bias

    def _rng(self, ctx: RunContext) -> np.random.RandomState:
        import hashlib

        key = (self.seed, ctx.run_id, ctx.asset, ctx.partition_key,
               ctx.attempt, self.platform.name)
        digest = hashlib.sha1(repr(key).encode()).digest()
        return np.random.RandomState(
            int.from_bytes(digest[:4], "little") % (2**31))

    def submit(self, job: JobSpec) -> RunHandle:
        h = RunHandle(job_id=uuid.uuid4().hex[:12], platform=self.platform.name)
        rng = self._rng(job.ctx)

        bias = (self.duration_bias(job.ctx) if callable(self.duration_bias)
                else self.duration_bias)

        def run():
            h.started = time.time()
            p = self.platform
            # simulated wall-clock: roofline estimate with log-normal jitter
            jitter = float(np.exp(rng.normal(0.0, 0.18))) * bias
            sim = job.estimate.duration_s * jitter
            draw = rng.uniform()
            try:
                failed = draw < self.failure_rate
                preempted = (not failed and
                             draw < self.failure_rate + self.preemption_rate)
                # partial progress before dying: drawn last so the
                # jitter/outcome stream is unchanged vs earlier seeds
                bad = failed or preempted
                frac = float(rng.uniform(0.2, 0.8)) if bad else 1.0
                if self.sim_time_scale > 0:
                    deadline = time.time() + sim * self.sim_time_scale * frac
                    while time.time() < deadline:
                        if h.cancelled:
                            h.finished = time.time()
                            return
                        time.sleep(min(0.002, deadline - time.time()))
                if failed:
                    raise PlatformError(
                        f"{p.name}: injected run failure (draw={draw:.3f})",
                        kind="failure")
                if preempted:
                    raise PlatformError(
                        f"{p.name}: injected preemption", kind="preemption")
                h.result = job.fn(job.ctx, *job.args, **job.kwargs)
                h.sim_duration_s = sim
            except Exception as e:
                h.error = e
                # failed/preempted attempts bill the partial progress they
                # actually burned (the drawn 0.2-0.8 fraction), not a flat
                # half — keeps billed cost consistent with simulated time
                h.sim_duration_s = sim * (frac if isinstance(e, PlatformError)
                                          else 1.0)
            h.finished = time.time()

        h.thread = threading.Thread(target=run, daemon=True)
        h.thread.start()
        return h
