"""The paper's contribution: cost-effective multi-platform orchestration
(port of ``repro.core``: standard library and numpy, float64 pricing that
matches the reference bit for bit given the same ``Accelerator``)."""
from repro_torch.core.adaptive import (AdaptiveConfig, AdaptiveController,  # noqa: F401
                                 CircuitBreaker, DriftDetector,
                                 OnlineCostModel)
from repro_torch.core.assets import (AssetGraph, AssetSpec, ComputeProfile,  # noqa: F401
                               RetryPolicy, asset)
from repro_torch.core.clients import (JobSpec, LocalClient, PlatformClient,  # noqa: F401
                                PlatformError, SimulatedClusterClient)
from repro_torch.core.context import ContextInjector, RunContext  # noqa: F401
from repro_torch.core.coordinator import RunCoordinator, RunReport  # noqa: F401
from repro_torch.core.costmodel import CostEstimate, CostModel  # noqa: F401
from repro_torch.core.factory import DynamicClientFactory, Objective  # noqa: F401
from repro_torch.core.faults import (ClientFaults, CoordinatorKilled,  # noqa: F401
                               FaultPlan)
from repro_torch.core.journal import (JournalCorruption, JournalState,  # noqa: F401
                                RunJournal)
from repro_torch.core.partitions import (MultiPartitions, PartitionsDefinition,  # noqa: F401
                                   StaticPartitions, TimeWindowPartitions,
                                   dep_partition_keys)
from repro_torch.core.planner import (PlannedChoice, RunPlan, RunPlanner,  # noqa: F401
                                plan_run)
from repro_torch.core.platforms import (H100_SXM, Accelerator,  # noqa: F401
                                        Platform, default_catalog)
from repro_torch.core.schedule import (ScheduleEngine, SlotConfig,  # noqa: F401
                                 SlotSchedule, task_dag)
from repro_torch.core.selection import AssetSelection  # noqa: F401
from repro_torch.core.store import (MaterializationStore, Staleness,  # noqa: F401
                              StoreCorruption, code_version,
                              resolve_staleness, source_hash)
from repro_torch.core.telemetry import Event, MessageReader  # noqa: F401
