"""Fleet orchestration of the port (counterpart of ``repro.fleet``): one
``Orchestrator.run(built, devices, policy)`` entry point over the engine's
drivers (``local``, ``adaptive``, ``distributed``, ``distributed_adaptive``,
``ensemble``), with
window-boundary checkpoints, the injected and the SIGKILL preemption lanes,
resume, retry and backoff caps, the device floor, and the host-side fleet
counters (``C_PREEMPT``/``C_RESUME``/``C_RESHARD``) booked through
``MetricsStream``.
"""
from repro_torch.fleet.orchestrator import (
    FleetError,
    FleetPolicy,
    Orchestrator,
    OrchestratorResult,
    PreemptionError,
)

__all__ = [
    "FleetError",
    "FleetPolicy",
    "Orchestrator",
    "OrchestratorResult",
    "PreemptionError",
]
