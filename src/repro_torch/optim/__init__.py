"""Optimizers, learning-rate schedules and int8 gradient compression with
error feedback (port of `repro/optim/`)."""
from repro_torch.optim.compression import (
    ErrorFeedback, compress_grads_int8, decompress_grads_int8,
    init_error_feedback)
from repro_torch.optim.optimizers import (
    OptState, adafactor, adamw, clip_by_global_norm)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = ["ErrorFeedback", "OptState", "adafactor", "adamw",
           "clip_by_global_norm", "compress_grads_int8", "cosine_schedule",
           "decompress_grads_int8", "init_error_feedback", "linear_warmup"]
