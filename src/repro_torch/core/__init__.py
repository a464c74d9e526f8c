"""Core of the port: registry, components, events, sync, network, handlers,
engine, oracle, monitoring streams, scheduler and contexts (the
counterparts of ``repro.core``)."""
from repro_torch.core.components import ScenarioBuilder  # noqa: F401
from repro_torch.core.engine import Engine, EngineState  # noqa: F401
from repro_torch.core.monitoring import (MetricsStream,  # noqa: F401
                                         TraceStream)
from repro_torch.core.oracle import (merged_engine_trace,  # noqa: F401
                                     run_sequential)
