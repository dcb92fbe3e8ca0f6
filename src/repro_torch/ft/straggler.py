"""Straggler detection and mitigation hooks: the port's copy of
`repro.ft.straggler`, numpy and the port's `core.fabric.FabricSpec`.

The monitor tracks per-step wall times and flags steps beyond a robust
threshold over the window's median.  Two mitigations hang off it:
re-planning the co-flows with the slow axis derated (`derated_fabric`,
fed to `core.fabric.plan_collectives`), and, once stragglers persist,
checkpoint-and-restart (`persistent`).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class StragglerEvent:
    step: int
    wall_s: float
    median_s: float
    severity: float            # wall / median


class HeartbeatMonitor:
    def __init__(self, window: int = 50, threshold: float = 2.0,
                 persistent_after: int = 3):
        self.window = window
        self.threshold = threshold
        self.persistent_after = persistent_after
        self.times: list[float] = []
        self.events: list[StragglerEvent] = []
        self._consecutive = 0
        self._t0: float | None = None

    # -- step timing ----------------------------------------------------
    def step_start(self):
        self._t0 = time.perf_counter()

    def step_end(self, step: int) -> StragglerEvent | None:
        if self._t0 is None:
            raise RuntimeError("step_end without step_start")
        return self.observe(step, time.perf_counter() - self._t0)

    def observe(self, step: int, wall_s: float) -> StragglerEvent | None:
        self.times.append(wall_s)
        hist = self.times[-self.window:]
        med = float(np.median(hist))
        if len(hist) >= 5 and wall_s > self.threshold * med:
            ev = StragglerEvent(step, wall_s, med, wall_s / med)
            self.events.append(ev)
            self._consecutive += 1
            return ev
        self._consecutive = 0
        return None

    @property
    def persistent(self) -> bool:
        """True when mitigation should escalate from re-scheduling to
        checkpoint-and-restart."""
        return self._consecutive >= self.persistent_after

    # -- mitigation 1: derate the fabric and re-plan ----------------------
    def derated_fabric(self, spec, axis: int, factor: float = 0.5):
        """A FabricSpec with the straggling axis derated; feed it to
        core.fabric.plan_collectives to re-schedule around it."""
        bw = list(spec.axis_bw)
        bw[axis] = bw[axis] * factor
        return dataclasses.replace(spec, axis_bw=tuple(bw))
