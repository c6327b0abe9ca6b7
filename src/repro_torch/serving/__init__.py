"""Continuous-batching serving for the port: plan, pool, scheduler, engine,
the recurrent-state prefix cache and self-speculative decode (the SLO
layer and snapshots wait for ROADMAP Queue 1 item 6)."""
from repro_torch.serving.engine import (RequestHandle, SamplingParams,
                                        ServingEngine)
from repro_torch.serving.plan import (ExecutionPlan, SpeculativePath,
                                      build_plan)
from repro_torch.serving.prefix_cache import (CacheVariant, PrefixCache,
                                              PrefixCacheConfig, StateLease)
from repro_torch.serving.scheduler import (Request, Scheduler,
                                           greedy_accept, sample_token)
from repro_torch.serving.state_pool import SlotStatePool

__all__ = ["ServingEngine", "SamplingParams", "RequestHandle", "Request",
           "Scheduler", "sample_token", "greedy_accept", "SlotStatePool",
           "ExecutionPlan", "SpeculativePath", "build_plan", "PrefixCache",
           "PrefixCacheConfig", "CacheVariant", "StateLease"]
