"""Service observability: latency histograms and counters.

A numpy copy of the reference `repro.service.metrics`.

Percentiles use the nearest-rank definition (the smallest recorded
value with at least p% of samples at or below it) rather than an
interpolating estimator: every reported quantile is then an actual
recorded latency, and — crucially for the deterministic replay tests —
formatting a percentile never depends on floating-point interpolation
details, so event logs stay byte-stable across runs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def nearest_rank(values: np.ndarray | list[float], p: float) -> float:
    """Nearest-rank percentile: the ceil(p/100 * n)-th smallest value.

    `p` in (0, 100]; returns nan on an empty sample."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        return float("nan")
    if not 0.0 < p <= 100.0:
        raise ValueError(f"p={p} not in (0, 100]")
    idx = max(int(math.ceil(p / 100.0 * v.size)) - 1, 0)
    return float(v[idx])


@dataclasses.dataclass
class LatencyStats:
    """Streaming collection of per-request decision latencies (seconds).

    `add` records one request's latency; the percentile properties
    (nearest-rank, see module docstring) answer the service's SLO
    questions: p50 the typical request, p99 the contractual tail,
    p999 the storm tail."""

    samples: list[float] = dataclasses.field(default_factory=list)

    def add(self, latency_s: float) -> None:
        if latency_s < 0.0 or not np.isfinite(latency_s):
            raise ValueError(f"bad latency {latency_s}")
        self.samples.append(float(latency_s))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def mean(self) -> float:
        return float(np.mean(self.samples)) if self.samples else float("nan")

    @property
    def max(self) -> float:
        return max(self.samples) if self.samples else float("nan")

    def percentile(self, p: float) -> float:
        return nearest_rank(self.samples, p)

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    @property
    def p999(self) -> float:
        return self.percentile(99.9)


@dataclasses.dataclass
class ServiceCounters:
    """Whole-run counters (all monotone; see docs/SERVICE.md)."""

    arrived: int = 0           # requests read off the interleaved stream
    admitted: int = 0          # requests scheduled into some window
    shed: int = 0              # rejected at arrival (waiting queue full)
    deferred: int = 0          # boundary defer decisions (tenant backlog
                               # cap; one request may defer many times)
    dispatches: int = 0        # coalesced solve dispatches issued
    solver_dispatches: int = 0 # stacked kernel dispatches underneath
                               # (escalation-ladder levels included)
    bucket_hits: int = 0       # solver dispatches landing on an already-
                               # dispatched stacked shape (DispatchStats
                               # delta; hit ratio = hits/solver_dispatches)
    retries: int = 0           # per-member rehorizon retry solves
    fallbacks: int = 0         # windows handed to the cheap baseline-
                               # policy tier (core.policies) after the
                               # retry ladder exhausted
    slo_breaches: int = 0      # requests whose decision latency > slo
    windows: int = 0           # coalescing windows executed
    chaos_events: int = 0      # chaos fail/repair events applied at
                               # window boundaries (core.chaos replay)
    stranded_flows: int = 0    # carried flows whose decomposed paths a
                               # failure killed (volume re-routed by the
                               # warm-start projection)
    failure_deferrals: int = 0 # flows parked as deferred-by-failure
                               # (endpoints disconnected; re-admitted on
                               # repair, never silently shed)


@dataclasses.dataclass
class RobustnessStats:
    """Chaos-replay outcome of one run (defaults on a healthy run).

    `availability` is the fraction of observed tenant-time with full
    admissible capacity — trace-exact, integrated piecewise between
    event times (core.chaos.degraded_seconds), independent of the
    window grid the trace was replayed on.  `recoveries` holds one
    time-to-recover sample per episode: from the failure event that
    stranded or deferred demand to the first certified re-plan whose
    deferred pool was empty.  See docs/CHAOS.md for definitions."""

    degraded_s: float = 0.0        # tenant-seconds with >= 1 active failure
    span_s: float = 0.0            # tenant-seconds observed
    events_applied: int = 0        # fail/repair events replayed
    stranded_gbits: float = 0.0    # carried volume re-routed after its
                                   # decomposed paths died
    deferred_gbits: float = 0.0    # demand still deferred-by-failure at
                                   # exit (endpoints never reconnected)
    recoveries: list[float] = dataclasses.field(default_factory=list)

    @property
    def availability(self) -> float:
        if self.span_s <= 0.0:
            return 1.0
        return 1.0 - self.degraded_s / self.span_s

    @property
    def mean_recover_s(self) -> float:
        return (float(np.mean(self.recoveries)) if self.recoveries
                else float("nan"))

    @property
    def p50_recover_s(self) -> float:
        return nearest_rank(self.recoveries, 50.0)
