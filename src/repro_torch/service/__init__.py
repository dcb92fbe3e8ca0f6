"""Scheduler-as-a-service: the multi-tenant coalescing solve loop.

The port of the reference `repro.service`: every coalesced dispatch
runs the port's solver on `ServiceConfig.device` (the CUDA burst kernel
on "cuda", its plain version on "cpu").

  clock   - virtual time + deterministic solve-cost models
  metrics - latency histograms (nearest-rank percentiles) + counters
  loop    - the service event loop (admission control, shape-bucketed
            coalescing into solve_fast_group dispatches, SLO accounting)

See docs/SERVICE.md for the lifecycle and policy reference.
"""
from . import clock, loop, metrics
from .clock import SolveCostModel, VirtualClock
from .loop import (Request, ServiceConfig, ServiceEvent, ServiceResult,
                   TenantResult, TenantSpec, run_service)
from .metrics import (LatencyStats, RobustnessStats, ServiceCounters,
                      nearest_rank)

__all__ = [
    "LatencyStats", "Request", "RobustnessStats", "ServiceConfig",
    "ServiceCounters", "ServiceEvent", "ServiceResult", "SolveCostModel",
    "TenantResult", "TenantSpec", "VirtualClock", "clock", "loop",
    "metrics", "nearest_rank", "run_service",
]
