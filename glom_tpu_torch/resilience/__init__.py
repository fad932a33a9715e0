"""Resilience of the port (``glom_tpu/resilience``): seeded fault
injection, checkpoint integrity and newest-valid fallback, the self-healing
supervisor, and elastic multi-host training (per-host fault domains,
coordinator election, re-planning on a change of host count)."""

from glom_tpu_torch.resilience.faultinject import (  # noqa: F401
    FaultError,
    FaultPlan,
    arm,
    armed,
    disarm,
    fire,
    injected,
)
from glom_tpu_torch.resilience.integrity import (  # noqa: F401
    IntegrityObserver,
    latest_valid_step,
    quarantine,
)
from glom_tpu_torch.resilience.supervisor import (  # noqa: F401
    GiveUp,
    PreemptionError,
    RestartPolicy,
    Supervisor,
    classify_failure,
)
from glom_tpu_torch.resilience.elastic import (  # noqa: F401
    CoordinatorLostError,
    ElasticContext,
    ElasticPlan,
    ElasticSupervisor,
    FaultDomain,
    HeartbeatTracker,
    HostPreemptedError,
    SimClock,
    elect_coordinator,
)
