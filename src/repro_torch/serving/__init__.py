"""Continuous-batching serving for the port: plan, pool, scheduler, engine,
the recurrent-state prefix cache, self-speculative decode, the SLO layer
(priorities, deadlines, a bounded queue with backpressure or shedding, the
prefill budget, the hang watchdog) and crash safety (tick-boundary
snapshots with a bitwise resume, weight checksums, the NaN/Inf sentinel
with quarantine and replay)."""
from repro_torch.serving.engine import (RequestHandle, SamplingParams,
                                        ServingEngine)
from repro_torch.serving.plan import (ExecutionPlan, SpeculativePath,
                                      build_plan)
from repro_torch.serving.prefix_cache import (CacheStorageError,
                                              CacheVariant, PrefixCache,
                                              PrefixCacheConfig, StateLease)
from repro_torch.serving.scheduler import (Request, Scheduler,
                                           greedy_accept, sample_token)
from repro_torch.serving.slo import (AdmissionPolicy, Overloaded,
                                     SchedulerHang, ServingSLO)
from repro_torch.serving.snapshot import (EngineSnapshot, IntegrityError,
                                          SnapshotConfig, SnapshotManager,
                                          load_snapshot, restore_engine)
from repro_torch.serving.state_pool import SlotStatePool

__all__ = ["ServingEngine", "SamplingParams", "RequestHandle", "Request",
           "Scheduler", "sample_token", "greedy_accept", "SlotStatePool",
           "ExecutionPlan", "SpeculativePath", "build_plan", "PrefixCache",
           "PrefixCacheConfig", "CacheVariant", "StateLease",
           "CacheStorageError", "ServingSLO", "AdmissionPolicy",
           "Overloaded", "SchedulerHang", "SnapshotConfig",
           "SnapshotManager", "EngineSnapshot", "IntegrityError",
           "load_snapshot", "restore_engine"]
