"""Learning-rate schedules: pure functions of the step, in f32 (port of
`repro/optim/schedules.py`).  `step` is an int or an integer tensor; the
result is a 0-d f32 tensor on the step's device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def linear_warmup(peak: float, warmup_steps: int):
    def fn(step):
        s = _f32(step)
        return peak * torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
    return fn


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    floor: float = 0.1):
    """Linear warmup -> cosine decay to floor*peak."""
    def fn(step):
        s = _f32(step)
        warm = torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak * warm * cos
    return fn
