"""Continuous-batching serving for the port: plan, pool, scheduler, engine
(the prefix cache, SLO layer and snapshots wait for ROADMAP Queue 1
item 6)."""
from repro_torch.serving.engine import (RequestHandle, SamplingParams,
                                        ServingEngine)
from repro_torch.serving.plan import ExecutionPlan, build_plan
from repro_torch.serving.scheduler import Request, Scheduler, sample_token
from repro_torch.serving.state_pool import SlotStatePool

__all__ = ["ServingEngine", "SamplingParams", "RequestHandle", "Request",
           "Scheduler", "sample_token", "SlotStatePool", "ExecutionPlan",
           "build_plan"]
