"""Continuous-batching serving for the port: plan, pool, scheduler, engine."""
from repro_torch.serving.engine import (RequestHandle, SamplingParams,
                                        ServingEngine)
from repro_torch.serving.plan import ExecutionPlan, build_plan

__all__ = ["ExecutionPlan", "RequestHandle", "SamplingParams",
           "ServingEngine", "build_plan"]
