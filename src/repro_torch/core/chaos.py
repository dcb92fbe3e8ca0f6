"""Chaos engine: seeded failure/repair event traces replayed mid-run.

A numpy copy of the reference `repro.core.chaos`; event traces and their
canonical text are byte-identical to the reference's
(tests/test_torch_chaos.py).

core.failures produces *static* degraded snapshots — one scenario,
solved offline.  Real fabrics degrade in time: a ToR dies at t = 3.2 s
with co-flows in flight, a storm cuts three links in one maintenance
window, a brown-out lifts two minutes later.  This module makes
failures *events*:

  * :func:`generate_events` draws a deterministic, seeded trace of
    ``(t, fail | repair, scenario)`` events from per-class MTBF/MTTR
    exponential models plus correlated "storm" bursts (several
    scenarios landing inside one short window, sharing a repair
    window), all reusing the `failures.py` degradation vocabulary
    (link cuts, ToR/OLT/AWGR-port outages, brown-outs, capacity
    scaling) via `failures.sample`;
  * :class:`FabricState` replays a trace over a pristine topology.  At
    every state change the current degraded Topology is recomputed as
    ``failures.apply(healthy, failures.compose(active))`` — the
    composition of the *currently active* scenarios applied to the
    healthy reference — so repairing the last failure returns the
    healthy object itself, bit-identical (`failures.repair` is the
    single-scenario statement of the same inverse);
  * :func:`degraded_seconds` / :func:`availability` integrate the
    trace exactly (piecewise between event times), independent of the
    epoch granularity a driver happens to replay it at.

The rolling-horizon driver accepts a trace (``run_online(chaos=...)``)
and applies events at epoch boundaries; see docs/CHAOS.md for the
recovery ladder and metric definitions (the reference's service loop,
which also replays traces, is not ported yet).

Determinism: every stream is seeded through crc32 tags of (module,
class/preset, topology name) plus the integer seed — byte-identical
traces across processes, platforms, and devices, immune to
PYTHONHASHSEED.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from . import failures
from .failures import FailureScenario
from .topology import Topology


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One timestamped failure or repair.

    `event_id` pairs each "fail" with its "repair"; the scenario name
    carries the id suffix so composed degraded-topology names are
    unambiguous."""

    t: float
    kind: str                 # "fail" | "repair"
    event_id: int
    scenario: FailureScenario

    def __post_init__(self):
        if self.kind not in ("fail", "repair"):
            raise ValueError(f"kind {self.kind!r} not in (fail, repair)")

    @property
    def line(self) -> str:
        """Canonical event-trace line (byte-stable per seed)."""
        return (f"t={self.t:.6f} {self.kind} event={self.event_id} "
                f"scenario={self.scenario.name}")


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """One chaos-process configuration.

    Each failure class in `classes` (a `failures.SCENARIOS` preset) is
    an independent renewal process: exponential(mtbf_s) gaps between
    failures, each repaired after an exponential(mttr_s) outage.  On
    top, `storms` correlated bursts land `storm_width` scenarios —
    drawn across all classes — inside one `storm_window_s` window,
    each repaired after exponential(storm_mttr_s)."""

    classes: tuple[str, ...] = ("link1", "switch")
    mtbf_s: float = 3.0
    mttr_s: float = 1.0
    horizon_s: float = 12.0
    storms: int = 0
    storm_width: int = 3
    storm_window_s: float = 0.25
    storm_mttr_s: float = 1.5
    max_events: int = 64

    def __post_init__(self):
        for c in self.classes:
            if c not in failures.SCENARIOS or c == "none":
                raise ValueError(f"unknown failure class {c!r}; have "
                                 f"{sorted(k for k in failures.SCENARIOS if k != 'none')}")
        if self.mtbf_s <= 0 or self.mttr_s <= 0 or self.horizon_s <= 0:
            raise ValueError("mtbf_s, mttr_s, horizon_s must be > 0")
        if self.storms < 0 or self.storm_width < 1:
            raise ValueError("storms must be >= 0, storm_width >= 1")
        if self.storm_window_s <= 0 or self.storm_mttr_s <= 0:
            raise ValueError("storm windows must be > 0")
        if self.max_events < 1:
            raise ValueError("max_events must be >= 1")


# Named presets for the sweep CLI (`--chaos storm,mtbf`): "mtbf" is the
# steady drizzle of independent link/switch outages; "storm" suppresses
# the background process (astronomic MTBF) and replays two correlated
# bursts that each cut three scenarios — links, switches, AWGR ports —
# in one quarter-second window.
PRESETS = {
    "mtbf": ChaosSpec(),
    "storm": ChaosSpec(classes=("link1", "switch", "device"),
                       mtbf_s=1e9, horizon_s=8.0, storms=2),
}


def generate_events(topo: Topology, spec: ChaosSpec, seed: int = 0, *,
                    base_id: int = 0, tag: str = "") -> list[ChaosEvent]:
    """Draw one deterministic chaos trace for a topology.

    Events are sorted by (t, repair-before-fail, event_id) — a repair
    and a fail landing on the same instant resolve repair-first, so a
    zero-length outage is a no-op.  `base_id`/`tag` namespace multiple
    traces over the same topology (the service generates one per
    preset per tenant)."""
    events: list[ChaosEvent] = []
    eid = base_id
    tagc = zlib.crc32(tag.encode())
    for cls in spec.classes:
        rng = np.random.default_rng(
            [zlib.crc32(b"chaos"), tagc, zlib.crc32(cls.encode()),
             zlib.crc32(topo.name.encode()), int(seed)])
        t = float(rng.exponential(spec.mtbf_s))
        n_cls = 0
        while t < spec.horizon_s and n_cls < spec.max_events:
            scen = failures.sample(topo, cls,
                                   int(rng.integers(2 ** 31 - 1)))
            scen = dataclasses.replace(scen, name=f"{scen.name}@{eid}")
            dur = float(rng.exponential(spec.mttr_s))
            events.append(ChaosEvent(t, "fail", eid, scen))
            events.append(ChaosEvent(t + dur, "repair", eid, scen))
            eid += 1
            n_cls += 1
            t += float(rng.exponential(spec.mtbf_s))
    rng = np.random.default_rng(
        [zlib.crc32(b"chaos-storm"), tagc,
         zlib.crc32(topo.name.encode()), int(seed)])
    for s in range(spec.storms):
        # storms spread evenly over the horizon (jittered within their
        # stripe) so a 2-storm trace exercises both early and late run
        stripe = spec.horizon_s / spec.storms
        t0 = s * stripe + float(rng.uniform(0.1, 0.9)) * stripe
        for _ in range(spec.storm_width):
            cls = spec.classes[int(rng.integers(len(spec.classes)))]
            scen = failures.sample(topo, cls,
                                   int(rng.integers(2 ** 31 - 1)))
            scen = dataclasses.replace(scen,
                                       name=f"storm{s}.{scen.name}@{eid}")
            t_f = t0 + float(rng.uniform(0.0, spec.storm_window_s))
            dur = float(rng.exponential(spec.storm_mttr_s))
            events.append(ChaosEvent(t_f, "fail", eid, scen))
            events.append(ChaosEvent(t_f + dur, "repair", eid, scen))
            eid += 1
    events.sort(key=lambda ev: (ev.t, ev.kind != "repair", ev.event_id))
    return events


def generate_preset_events(topo: Topology, presets, seed: int = 0
                           ) -> list[ChaosEvent]:
    """One merged trace from named `PRESETS`, disjointly id-spaced."""
    events: list[ChaosEvent] = []
    base = 0
    for name in presets:
        if name not in PRESETS:
            raise KeyError(f"unknown chaos preset {name!r}; "
                           f"have {sorted(PRESETS)}")
        spec = PRESETS[name]
        events.extend(generate_events(topo, spec, seed,
                                      base_id=base, tag=name))
        # reserve the whole id budget of this preset's trace so a later
        # preset can never collide, whatever the draw produced
        base += spec.max_events * len(spec.classes) \
            + spec.storms * spec.storm_width
    events.sort(key=lambda ev: (ev.t, ev.kind != "repair", ev.event_id))
    return events


def format_trace(events: list[ChaosEvent]) -> str:
    """Canonical one-line-per-event rendering (tests pin these bytes)."""
    return "\n".join(ev.line for ev in events)


def degraded_seconds(events: list[ChaosEvent], t_end: float) -> float:
    """Exact seconds in [0, t_end) with at least one active failure.

    Integrates the trace piecewise between event times — independent of
    whatever epoch grid a driver replays the trace on."""
    active = 0
    total = 0.0
    t_prev = 0.0
    for ev in sorted(events, key=lambda e: (e.t, e.kind != "repair",
                                            e.event_id)):
        t = min(max(ev.t, 0.0), t_end)
        if active > 0:
            total += max(t - t_prev, 0.0)
        t_prev = t
        active += 1 if ev.kind == "fail" else -1
        if ev.t >= t_end:
            break
    if active > 0 and t_prev < t_end:
        total += t_end - t_prev
    return total


def availability(events: list[ChaosEvent], t_end: float) -> float:
    """Fraction of [0, t_end) with full admissible capacity (1.0 on an
    empty trace or a degenerate span)."""
    if t_end <= 0.0 or not events:
        return 1.0
    return 1.0 - degraded_seconds(events, t_end) / t_end


class FabricState:
    """Replays a chaos trace over a pristine topology.

    `advance_to(t)` applies every event with ``ev.t <= t`` and reports
    (applied events, capacities changed).  The current `topo` is always
    ``apply(healthy, compose(active))`` — and the healthy object itself
    when the active set is empty, so a fully-repaired fabric is
    bit-identical to the one the run started with (same array object,
    same solver structure-cache key)."""

    def __init__(self, healthy: Topology, events: list[ChaosEvent]):
        self.healthy = healthy
        self.events = sorted(events, key=lambda ev: (ev.t,
                                                     ev.kind != "repair",
                                                     ev.event_id))
        self._cursor = 0
        self._active: dict[int, FailureScenario] = {}
        self._topo = healthy
        self.t = 0.0
        self.applied = 0

    @property
    def topo(self) -> Topology:
        return self._topo

    @property
    def degraded(self) -> bool:
        return bool(self._active)

    @property
    def active_names(self) -> tuple[str, ...]:
        return tuple(s.name for s in self._active.values())

    @property
    def next_event_t(self) -> float | None:
        """Time of the next unapplied event (None when exhausted)."""
        if self._cursor < len(self.events):
            return self.events[self._cursor].t
        return None

    def advance_to(self, t: float) -> tuple[list[ChaosEvent], bool]:
        """Apply all events due by `t`; returns (applied, cap changed).

        `changed` compares resulting capacity bytes with the previous
        state — a fail + repair pair landing inside one boundary
        interval nets out to *no change* (the provable-no-op storm)."""
        if t < self.t - 1e-9:
            raise ValueError(f"cannot rewind fabric clock "
                             f"{self.t:.6f} -> {t:.6f}")
        applied: list[ChaosEvent] = []
        while (self._cursor < len(self.events)
               and self.events[self._cursor].t <= t + 1e-9):
            ev = self.events[self._cursor]
            self._cursor += 1
            if ev.kind == "fail":
                self._active[ev.event_id] = ev.scenario
            else:
                self._active.pop(ev.event_id, None)
            applied.append(ev)
            self.applied += 1
        self.t = t
        if not applied:
            return applied, False
        old_cap = self._topo.cap
        if self._active:
            scen = failures.compose(list(self._active.values()))
            self._topo = failures.apply(self.healthy, scen)
        else:
            self._topo = self.healthy
        return applied, not np.array_equal(old_cap, self._topo.cap)
