"""Host-side runtime monitors (port of `repro/runtime/`)."""
from repro_torch.runtime.monitor import (ServingCounters, StragglerDetector,
                                         percentile)

__all__ = ["ServingCounters", "StragglerDetector", "percentile"]
