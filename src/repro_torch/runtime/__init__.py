"""Host-side runtime monitors (port of `repro/runtime/`)."""
from repro_torch.runtime.monitor import StragglerDetector

__all__ = ["StragglerDetector"]
