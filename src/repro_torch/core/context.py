"""Context Injector (paper component #1): builds the per-run context —
partition key, environment layering, tags, platform + mesh config — and
injects it as the first argument of every asset function.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

from repro_torch.core.assets import AssetSpec
from repro_torch.core.platforms import Platform
from repro_torch.core.telemetry import MessageReader


@dataclasses.dataclass
class RunContext:
    run_id: str
    asset: str
    partition_key: str
    platform: Platform
    attempt: int
    env: dict[str, str]
    tags: dict[str, str]
    artifacts_dir: str
    reader: MessageReader | None = None

    @property
    def partition_dims(self) -> dict[str, str]:
        """Split a multi-partition key 'a/b' into named dims when possible."""
        if "/" in self.partition_key:
            parts = self.partition_key.split("/")
            names = ["time", "domain"][: len(parts)]
            return dict(zip(names, parts))
        return {"key": self.partition_key}

    def log(self, kind: str, **payload: Any) -> None:
        if self.reader is not None:
            self.reader.emit(self.run_id, self.asset, self.partition_key,
                             self.platform.name, kind, **payload)

    def heartbeat(self, **payload: Any) -> None:
        self.log("HEARTBEAT", **payload)


class ContextInjector:
    """Layered env/config injection: base env < platform env < asset tags
    < per-run overrides (the paper's 'general and job-specific
    configurations, including environmental variables, partitioning and
    tagging')."""

    def __init__(self, base_env: dict[str, str] | None = None,
                 artifacts_root: str = "artifacts/runs",
                 reader: MessageReader | None = None):
        self.base_env = dict(base_env or {})
        self.artifacts_root = artifacts_root
        self.reader = reader

    def build(self, run_id: str, spec: AssetSpec, partition_key: str,
              platform: Platform, attempt: int,
              overrides: dict[str, str] | None = None) -> RunContext:
        env = dict(self.base_env)
        env.update({
            "REPRO_PLATFORM": platform.name,
            "REPRO_MESH": "x".join(map(str, platform.mesh_shape)),
            "REPRO_PARTITION": partition_key,
        })
        env.update(overrides or {})
        tags = dict(spec.tags)
        tags.setdefault("asset", spec.name)
        tags.setdefault("speedup_class", spec.compute.speedup_class)
        art = os.path.join(self.artifacts_root, run_id,
                           spec.name, partition_key.replace("/", "_"))
        return RunContext(
            run_id=run_id, asset=spec.name, partition_key=partition_key,
            platform=platform, attempt=attempt, env=env, tags=tags,
            artifacts_dir=art, reader=self.reader)
