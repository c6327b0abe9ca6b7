"""Host-side runtime monitors (port of `repro/runtime/`): health,
stragglers, the training drill's supervisor and the serving telemetry."""
from repro_torch.runtime.monitor import (
    EngineCrash, FailureInjector, HeartbeatMonitor, HostFailure,
    ServingCounters, ServingFaultInjector, StragglerDetector,
    TrainingSupervisor, percentile)

__all__ = ["HeartbeatMonitor", "StragglerDetector", "FailureInjector",
           "TrainingSupervisor", "HostFailure", "ServingCounters",
           "percentile", "EngineCrash", "ServingFaultInjector"]
