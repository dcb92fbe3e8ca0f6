"""Virtual time for the scheduler service.

A copy of the reference `repro.service.clock`.  The service loop
(repro_torch.service.loop) never reads the wall clock for
control decisions — every timestamp it reasons about comes through a
:class:`VirtualClock` and every solve's control-plane cost comes
through a :class:`SolveCostModel`.  With the default deterministic
"iterations" cost model the whole service run — coalescing windows,
decision latencies, SLO breaches, overload sheds, the event log — is a
pure function of (tenant specs, config, device), which is what makes
tail-latency behavior unit-testable (tests/test_torch_service.py replays
runs byte-for-byte).  The "measured" model swaps in real wall time for
benchmarking on live hardware: a dispatch's wall is read after its
results reach the host (the solves end in host numpy), so the card's
work is inside it.

Units follow the paper: seconds everywhere.
"""
from __future__ import annotations

import dataclasses

COST_MODES = ("iterations", "measured")


class VirtualClock:
    """A monotone simulated clock.

    `now()` reads the current virtual time; `advance(dt)` / `advance_to(t)`
    move it forward (never backward — attempts to rewind raise, which is
    the monotonicity property the soak test asserts)."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0.0:
            raise ValueError(f"clock cannot rewind (dt={dt})")
        self._t += float(dt)
        return self._t

    def advance_to(self, t: float) -> float:
        if t < self._t - 1e-12:
            raise ValueError(f"clock cannot rewind ({self._t} -> {t})")
        self._t = max(self._t, float(t))
        return self._t


@dataclasses.dataclass(frozen=True)
class SolveCostModel:
    """Control-plane cost of one coalesced solve dispatch.

    mode="iterations" (default) charges a deterministic affine model —

        cost_s = base_s + per_iteration_s * iters + per_instance_s * B

    — where `iters` is the PDHG iterations the dispatch actually spent
    (deterministic for a fixed device and summation order; the card and
    the CPU may differ, see ROADMAP queue 3) and `B` its member
    count.  `base_s` models the fixed dispatch overhead (packing, kernel
    launches) that coalescing amortizes across tenants; `per_instance_s`
    the per-member LP assembly/unpack work that it cannot.

    mode="measured" charges the measured wall time of the dispatch
    instead — non-deterministic, for live benchmarking only."""

    mode: str = "iterations"
    base_s: float = 5e-3
    per_iteration_s: float = 2e-6
    per_instance_s: float = 1e-3

    def __post_init__(self):
        if self.mode not in COST_MODES:
            raise ValueError(f"mode {self.mode!r} not in {COST_MODES}")

    def cost_s(self, *, iterations: int, n_members: int,
               wall_s: float) -> float:
        if self.mode == "measured":
            return float(wall_s)
        return (self.base_s + self.per_iteration_s * iterations
                + self.per_instance_s * n_members)
