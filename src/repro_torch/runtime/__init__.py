"""Host-side runtime monitors (port of `repro/runtime/`)."""
from repro_torch.runtime.monitor import (EngineCrash, ServingCounters,
                                         ServingFaultInjector,
                                         StragglerDetector, percentile)

__all__ = ["ServingCounters", "StragglerDetector", "percentile",
           "EngineCrash", "ServingFaultInjector"]
