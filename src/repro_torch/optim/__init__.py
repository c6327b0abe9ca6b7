"""Optimizers and learning-rate schedules (port of `repro/optim/`; the
int8 gradient compression waits for ROADMAP Queue 1 item 8c)."""
from repro_torch.optim.optimizers import (
    OptState, adafactor, adamw, clip_by_global_norm)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = ["OptState", "adafactor", "adamw", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup"]
