"""Synthetic training data (port of `repro/data/`)."""
from repro_torch.data.pipeline import (
    SyntheticLM, batch_specs, make_batch_iterator)

__all__ = ["SyntheticLM", "batch_specs", "make_batch_iterator"]
