"""The multi-tenant scheduler service loop.

The port of the reference `repro.service.loop`, on `ServiceConfig.device`.

`run_service` turns the rolling-horizon arrival engine (core.arrivals)
into a long-lived scheduler serving N concurrent tenants — each a
`(topology, TrafficPattern, ArrivalSpec)` triple with its own seeded
arrival stream and objective — over shared solver infrastructure:

  * tenant traces are interleaved into one deterministic global
    request stream (arrivals.interleave_traces);
  * time advances on a fixed *coalescing-window* grid; at every
    boundary the loop admits waiting requests (admission control, see
    below), merges each ready tenant's carried residuals + admissions
    into a fresh ScheduleProblem exactly like run_online's epochs, and
    groups ready tenants by their *bucketed LP shape* (power-of-two
    brackets of (n, m_eq, m_ub, nnz), see `_shape_key`) so same-bucket
    tenants share one stacked `solve_fast_group` dispatch;
  * while one group's dispatch runs on the device, the next group's LP
    builds are prefetched on a CPU worker thread (the structure cache
    makes the in-dispatch rebuild a cheap assembly pass; the solver's
    caches and their counters take a lock, so the two threads never
    race on them);
  * admission control bounds the blast radius of overload: the global
    waiting queue sheds requests past `max_pending` at arrival, and a
    tenant whose backlog would exceed `max_backlog_gbits` defers
    further admissions to later boundaries (retried, not dropped);
  * the control plane is modeled as a single serialized solve queue
    (`control_free`): each group's SolveCostModel cost accumulates,
    and a request's *decision latency* is the control-plane completion
    time of the window that first scheduled it minus its arrival time
    — queueing delay from deferrals included.  p50/p99/p999 come from
    nearest-rank histograms (repro_torch.service.metrics); breaches of
    `slo_p99_s` are counted per request;
  * a tenant whose per-window rehorizon retry ladder still leaves
    residual demand (or an infeasible schedule) falls back to a cheap
    baseline policy (`ServiceConfig.fallback_policy`, core.policies)
    on a stretched horizon — accepted only when the policy schedule
    certifies feasible and drains the demand (`counters.fallbacks`).

Every timestamp flows through the injectable VirtualClock and (in the
default "iterations" cost mode) every control-plane cost is a
deterministic function of solver iteration counts, so two runs with
identical specs produce byte-identical event logs — the replay
property tests/test_torch_service.py pins on the CPU and chip_smoke.py
on the card.

Units follow the paper: Gbits, Gbps, seconds, Joules.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import torch

from .. import device as _device
from ..core import failures, solver, verify
from ..core import chaos as chaosmod
from ..core import policies as policy_zoo
from ..core.arrivals import (Arrival, ArrivalSpec, TenantArrival,
                             flow_progress, generate_trace,
                             interleave_traces)
from ..core.timeslot import (ScheduleProblem, prefix_energy, rehorizon,
                             suggest_n_slots)
from ..core.topology import Topology
from ..core.traffic import CoflowSet, TrafficPattern
from .clock import SolveCostModel, VirtualClock
from .metrics import LatencyStats, RobustnessStats, ServiceCounters


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: a topology + traffic pattern + arrival process.

    `trace` overrides the generated arrival stream with an explicit one
    (tests craft simultaneous-arrival and mid-epoch edge cases this
    way); otherwise `generate_trace(topo, pattern, arrivals, seed)`
    supplies it."""

    name: str
    topo: Topology
    pattern: TrafficPattern
    arrivals: ArrivalSpec | None = None
    seed: int = 0
    objective: str = "energy"
    trace: list[Arrival] | None = None

    def __post_init__(self):
        if self.objective not in ("energy", "time", "fair"):
            raise ValueError(f"objective {self.objective!r}")
        if self.arrivals is None and self.trace is None:
            raise ValueError(f"tenant {self.name}: needs arrivals or trace")

    def make_trace(self) -> list[Arrival]:
        if self.trace is not None:
            return self.trace
        return generate_trace(self.topo, self.pattern, self.arrivals,
                              self.seed)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Service-wide knobs (see docs/SERVICE.md for the full story)."""

    window_s: float | None = None   # coalescing window; default 4x the
                                    # largest tenant slot duration
    iters: int = 3000               # per-window PDHG budget (first rung)
    tol: float | None = 2e-3
    chunk: int = 250
    device: str | torch.device = "cuda"   # where the bursts run
    coalesce: bool = True           # False: one dispatch per tenant
    bucket: bool = True
    warm: bool = True
    overlap_build: bool = True      # prefetch next group's LP builds on
                                    # a CPU thread during device solves
    max_pending: int = 64           # global waiting-queue bound (shed)
    max_backlog_gbits: float = float("inf")   # per-tenant defer bound
    slo_p99_s: float = 0.25         # decision-latency SLO
    cost: SolveCostModel = dataclasses.field(default_factory=SolveCostModel)
    max_windows: int = 256
    rho: float = 8.0
    q_weight: float = 100.0
    path_slack: int | None = 2
    fallback_policy: str | None = "scf"  # baseline policy (core.policies)
                                    # handed a window when a tenant's
                                    # rehorizon retry ladder exhausts;
                                    # None disables the tier
    verify_schedules: bool = False  # assert a core.verify feasibility
                                    # certificate on every member result
    chaos: tuple[str, ...] = ()     # core.chaos PRESETS to replay per
                                    # tenant (failure/repair events at
                                    # window boundaries); empty disables
                                    # the engine — and leaves event logs
                                    # byte-identical to healthy runs
    chaos_seed: int = 0             # chaos trace seed (per-tenant
                                    # streams derive from seed + index)


@dataclasses.dataclass
class Request:
    """One co-flow request's lifecycle through the service."""

    tenant: int
    coflow_id: int
    t_arrive: float
    gbits: float
    n_flows: int
    status: str = "waiting"        # waiting | shed | scheduled | done
    t_decision: float = float("nan")
    t_done: float = float("nan")

    @property
    def latency_s(self) -> float:
        return self.t_decision - self.t_arrive


@dataclasses.dataclass(frozen=True)
class ServiceEvent:
    """One event-log line; `line` is the canonical formatted text."""

    t: float
    kind: str
    line: str


@dataclasses.dataclass
class TenantResult:
    name: str
    n_arrived: int = 0
    n_done: int = 0
    shipped_gbits: float = 0.0
    backlog_gbits: float = 0.0
    energy_j: float = 0.0
    makespan_s: float = float("nan")


@dataclasses.dataclass
class ServiceResult:
    """Aggregate outcome of one service run."""

    events: list[ServiceEvent]
    requests: list[Request]
    tenants: list[TenantResult]
    latency: LatencyStats
    counters: ServiceCounters
    makespan_s: float
    total_energy_j: float
    backlog_gbits: float
    robustness: RobustnessStats = dataclasses.field(
        default_factory=RobustnessStats)
    latency_degraded: LatencyStats = dataclasses.field(
        default_factory=LatencyStats)

    def event_log(self) -> str:
        """The canonical event log: one line per event, in order.

        Deterministic byte-for-byte for fixed (specs, config, device)
        under the "iterations" cost model."""
        return "\n".join(e.line for e in self.events)

    @property
    def completed_per_s(self) -> float:
        """Sustained throughput: requests fully served per second of
        virtual makespan."""
        done = sum(r.status == "done" for r in self.requests)
        return done / self.makespan_s if self.makespan_s > 0 else 0.0


@dataclasses.dataclass
class _Tenant:
    """Mutable per-tenant rolling-horizon state (mirrors run_online)."""

    spec: TenantSpec
    window_slots: int
    c_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    c_dst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    c_res: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float64))
    c_cid: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    c_prev: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    prev: solver.FastPathResult | None = None
    admitted: list = dataclasses.field(default_factory=list)
    unfinished: dict = dataclasses.field(default_factory=dict)
    # chaos-replay state (inert unless ServiceConfig.chaos is set):
    # the per-tenant fabric, the deferred-by-failure flow pool, and the
    # open recovery episode
    fabric: chaosmod.FabricState | None = None
    d_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    d_dst: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    d_res: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float64))
    d_cid: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    retry_deferred: bool = False    # a boundary changed the fabric while
                                    # deferred demand waited — re-probe
    cap_changed: bool = False       # capacities changed at this boundary
    last_fail_t: float | None = None
    recover_open: float | None = None

    @property
    def backlog_gbits(self) -> float:
        carried = float(self.c_res.sum())
        return carried + sum(a.coflow.total_gbits for a in self.admitted)

    @property
    def deferred_gbits(self) -> float:
        return float(self.d_res.sum())

    @property
    def ready(self) -> bool:
        return (bool(self.admitted) or self.c_res.size > 0
                or self.retry_deferred)


def _merge(st: _Tenant) -> tuple[ScheduleProblem, np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]:
    """Carried residuals + this window's admissions -> one epoch problem
    (exactly run_online's merge step); returns (p, size, cid, flow_map,
    src)."""
    spec = st.spec
    new_src = [a.coflow.src for a in st.admitted]
    new_dst = [a.coflow.dst for a in st.admitted]
    new_size = [a.coflow.size for a in st.admitted]
    new_cid = [np.full(a.coflow.n_flows, a.coflow_id, np.int64)
               for a in st.admitted]
    src = np.concatenate([st.c_src] + new_src).astype(np.int64)
    dst = np.concatenate([st.c_dst] + new_dst).astype(np.int64)
    size = np.concatenate([st.c_res] + new_size).astype(np.float64)
    cid = np.concatenate([st.c_cid] + new_cid).astype(np.int64)
    flow_map = np.concatenate(
        [st.c_prev, np.full(len(src) - len(st.c_prev), -1, np.int64)])
    return src, dst, size, cid, flow_map


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _shape_key(lp) -> tuple[int, int, int, int]:
    """The coalescing bucket of one tenant's per-window LP: its
    dimensions rounded up to powers of two.

    Block stacking is exact for heterogeneous members, so grouping only
    decides *padding economics*: members within the same power-of-two
    bracket waste at most ~2x on the worst dimension, and in practice
    same-pattern tenants land within a few percent of each other.  The
    coarse key therefore merges them reliably."""
    return (_pow2(lp.n), _pow2(lp.m_eq), _pow2(lp.m - lp.m_eq),
            _pow2(len(lp.val)))


def run_service(tenants: list[TenantSpec],
                config: ServiceConfig = ServiceConfig(),
                clock: VirtualClock | None = None) -> ServiceResult:
    """Run the multi-tenant scheduler service to stream exhaustion.

    Admits every tenant's arrival trace through the shared coalescing
    loop described in the module docstring and returns the full
    observable record: canonical event log, per-request lifecycles,
    decision-latency histogram, counters, and per-tenant paper-model
    metrics (energy of executed prefixes, completions with the eq. 39
    in-slot convention).  `max_windows` bounds the run; any work left
    when it trips is reported as backlog, never silently dropped."""
    if not tenants:
        raise ValueError("need at least one tenant")
    dev = _device.resolve(config.device)
    fallback = (policy_zoo.get(config.fallback_policy)
                if config.fallback_policy else None)
    clock = clock or VirtualClock()
    window_s = config.window_s
    if window_s is None:
        window_s = 4.0 * max(t.topo.slot_duration for t in tenants)

    states = [_Tenant(t, max(1, int(round(window_s / t.topo.slot_duration))))
              for t in tenants]
    if config.chaos:
        # one independent seeded fabric per tenant; traces are pure
        # functions of (topo, presets, derived seed), so any consumer
        # can regenerate them byte-identically
        for k, st in enumerate(states):
            st.fabric = chaosmod.FabricState(
                st.spec.topo,
                chaosmod.generate_preset_events(
                    st.spec.topo, config.chaos,
                    seed=config.chaos_seed * 65536 + k))
    robustness = RobustnessStats()
    latency_degraded = LatencyStats()
    stream: list[TenantArrival] = interleave_traces(
        [t.make_trace() for t in tenants])
    requests: dict[tuple[int, int], Request] = {}
    waiting: list[TenantArrival] = []
    events: list[ServiceEvent] = []
    latency = LatencyStats()
    counters = ServiceCounters()
    tres = [TenantResult(name=t.name) for t in tenants]
    disp0 = solver.dispatch_stats().snapshot()

    def emit(kind: str, text: str) -> None:
        t = clock.now()
        events.append(ServiceEvent(t, kind, f"t={t:.6f} {kind} {text}"))

    control_free = 0.0
    makespan = float("nan")
    total_energy = 0.0
    next_arr = 0                    # cursor into the interleaved stream
    window = 0
    pool = ThreadPoolExecutor(1) if config.overlap_build else None
    try:
        while window < config.max_windows:
            t_w = clock.now()
            # -- arrivals: pull everything due, shed past the queue bound
            while (next_arr < len(stream)
                   and stream[next_arr].arrival.t_arrive <= t_w + 1e-9):
                ta = stream[next_arr]
                next_arr += 1
                a = ta.arrival
                req = Request(ta.tenant, a.coflow_id, a.t_arrive,
                              a.coflow.total_gbits, a.coflow.n_flows)
                requests[(ta.tenant, a.coflow_id)] = req
                counters.arrived += 1
                tres[ta.tenant].n_arrived += 1
                emit("arrive", f"tenant={ta.tenant} coflow={a.coflow_id} "
                               f"gbits={req.gbits:.6f}")
                if len(waiting) >= config.max_pending:
                    req.status = "shed"
                    counters.shed += 1
                    emit("shed", f"tenant={ta.tenant} coflow={a.coflow_id} "
                                 f"queue={len(waiting)}")
                else:
                    waiting.append(ta)

            # -- admission: FIFO through the queue, per-tenant backlog cap.
            # A tenant with an empty backlog always admits its head request
            # (otherwise an oversize request would starve forever).
            still_waiting: list[TenantArrival] = []
            for ta in waiting:
                st = states[ta.tenant]
                b = st.backlog_gbits
                g = ta.arrival.coflow.total_gbits
                if b == 0.0 or b + g <= config.max_backlog_gbits:
                    st.admitted.append(ta.arrival)
                    st.unfinished[ta.arrival.coflow_id] = \
                        int(ta.arrival.coflow.n_flows)
                    counters.admitted += 1
                    emit("admit", f"tenant={ta.tenant} "
                                  f"coflow={ta.arrival.coflow_id} "
                                  f"window={window}")
                else:
                    counters.deferred += 1
                    emit("defer", f"tenant={ta.tenant} "
                                  f"coflow={ta.arrival.coflow_id} "
                                  f"backlog={b:.6f}")
                    still_waiting.append(ta)
            waiting = still_waiting

            # -- chaos: replay every due failure/repair event on each
            # tenant's fabric.  A changed fabric with parked
            # deferred-by-failure demand makes the tenant ready again
            # (retry_deferred) so repairs are probed at this boundary.
            if config.chaos:
                for k, st in enumerate(states):
                    applied, changed = st.fabric.advance_to(t_w)
                    fail_ts = [ev.t for ev in applied if ev.kind == "fail"]
                    for ev in applied:
                        counters.chaos_events += 1
                        emit(ev.kind, f"tenant={k} event={ev.event_id} "
                                      f"scenario={ev.scenario.name}")
                    if changed:
                        st.cap_changed = True
                        if st.d_res.size:
                            st.retry_deferred = True
                    if fail_ts:
                        st.last_fail_t = min(fail_ts)

            ready = [k for k, st in enumerate(states) if st.ready]
            if not ready:
                # a tenant whose demand is deferred-by-failure is not
                # "ready" (nothing routable) but is not drained either:
                # wait for its fabric's next event, never break on it
                nxt_evt = None
                if config.chaos:
                    ts = [st.fabric.next_event_t for st in states
                          if st.d_res.size
                          and st.fabric.next_event_t is not None]
                    nxt_evt = min(ts) if ts else None
                if next_arr >= len(stream) and not waiting:
                    if nxt_evt is None:
                        break       # drained: stream done, queues empty
                                    # (deferred demand, if any, can never
                                    # reconnect — reported as deferred)
                    t_next = nxt_evt
                else:
                    # idle gap: jump to the grid boundary admitting the
                    # next arrival (or the next chaos event touching a
                    # deferred tenant, whichever lands first)
                    t_next = stream[next_arr].arrival.t_arrive
                    if nxt_evt is not None:
                        t_next = min(t_next, nxt_evt)
                steps = max(1.0, np.ceil((t_next - t_w) / window_s - 1e-9))
                clock.advance_to(t_w + window_s * steps)
                continue

            more_chaos = config.chaos and any(
                st.fabric.next_event_t is not None for st in states)
            last = (next_arr >= len(stream) and not waiting
                    and not more_chaos)

            # -- build each ready tenant's merged epoch problem + LP
            members = {}
            for k in ready:
                st = states[k]
                src, dst, size, cid, flow_map = _merge(st)
                if config.chaos and st.d_res.size:
                    # deferred-by-failure flows rejoin every boundary's
                    # candidate set (cold, flow_map -1); routability on
                    # the *current* fabric decides their fate below
                    src = np.concatenate([src, st.d_src])
                    dst = np.concatenate([dst, st.d_dst])
                    size = np.concatenate([size, st.d_res])
                    cid = np.concatenate([cid, st.d_cid])
                    flow_map = np.concatenate(
                        [flow_map, np.full(st.d_res.size, -1, np.int64)])
                topo_k = (st.fabric.topo if config.chaos
                          else st.spec.topo)
                cf = CoflowSet(src, dst, size, st.spec.topo.n_vertices)
                p = ScheduleProblem(
                    topo_k, cf,
                    n_slots=suggest_n_slots(topo_k, cf, rho=config.rho),
                    rho=config.rho, q_weight=config.q_weight,
                    path_slack=config.path_slack)
                deferred = np.zeros(len(size), bool)
                if config.chaos and st.fabric.degraded:
                    # flows whose endpoints the active failures
                    # disconnected enter the problem with zero size
                    # (index-preserving, so warm-start projection still
                    # lines up) and park as deferred-by-failure — never
                    # silently shed
                    deferred = ~failures.routable_flows(p) & (size > 1e-9)
                    if deferred.any():
                        cf = CoflowSet(src, dst,
                                       np.where(deferred, 0.0, size),
                                       st.spec.topo.n_vertices)
                        # recompute the horizon for the surviving demand
                        # — a disconnected source makes the first
                        # estimate balloon (offered Gbits over ~zero
                        # admissible egress capacity)
                        p = ScheduleProblem(
                            topo_k, cf,
                            n_slots=suggest_n_slots(topo_k, cf,
                                                    rho=config.rho),
                            rho=config.rho, q_weight=config.q_weight,
                            path_slack=config.path_slack)
                        n_def = int(deferred.sum())
                        counters.failure_deferrals += n_def
                        emit("deferfail",
                             f"tenant={k} flows={n_def} "
                             f"gbits={float(size[deferred].sum()):.6f}")
                        if st.recover_open is None:
                            st.recover_open = min(
                                st.last_fail_t if st.last_fail_t
                                is not None else t_w, t_w)
                if (config.chaos and st.cap_changed and config.warm
                        and st.prev is not None
                        and st.prev.schedule.shape[0] > 0):
                    # carried flows whose decomposed paths died: the
                    # warm-start projection drops and re-routes exactly
                    # this volume — account it as stranded
                    sv = solver.stranded_volume(st.prev, p,
                                                flow_map=flow_map)
                    g_str = float(sv.sum())
                    if g_str > 1e-9:
                        n_str = int((sv > 1e-9).sum())
                        robustness.stranded_gbits += g_str
                        counters.stranded_flows += n_str
                        emit("strand", f"tenant={k} flows={n_str} "
                                       f"gbits={g_str:.6f}")
                        if st.recover_open is None:
                            st.recover_open = min(
                                st.last_fail_t if st.last_fail_t
                                is not None else t_w, t_w)
                st.cap_changed = False
                st.retry_deferred = False
                lp, _ = solver.build_routing_lp(p, st.spec.objective)
                members[k] = dict(p=p, src=src, dst=dst, size=size, cid=cid,
                                  flow_map=flow_map, deferred=deferred,
                                  key=_shape_key(lp))

            # -- coalesce: same-bucket tenants share one stacked dispatch
            if config.coalesce:
                groups: dict[tuple, list[int]] = {}
                for k in ready:
                    groups.setdefault(members[k]["key"], []).append(k)
                group_list = sorted(groups.values(), key=lambda g: g[0])
            else:
                group_list = [[k] for k in ready]

            control_free = max(t_w, control_free)
            for gi, grp in enumerate(group_list):
                if pool is not None and gi + 1 < len(group_list):
                    # prefetch the next group's LP builds (structure
                    # cache) while this group's dispatch runs on device
                    nxt = [(members[k]["p"], states[k].spec.objective)
                           for k in group_list[gi + 1]]
                    prefetch = pool.submit(
                        lambda items: [solver.build_routing_lp(p, o)
                                       for p, o in items], nxt)
                else:
                    prefetch = None
                probs = [members[k]["p"] for k in grp]
                objs = [states[k].spec.objective for k in grp]
                warms, maps = [], []
                for k in grp:
                    st = states[k]
                    ok = (config.warm and st.prev is not None
                          and members[k]["p"].coflow.n_flows > 0
                          and st.prev.schedule.shape[0] > 0)
                    warms.append(st.prev if ok else None)
                    maps.append(members[k]["flow_map"] if ok else None)
                t0 = time.perf_counter()
                results = solver.solve_fast_group(
                    probs, objs, warm=warms, flow_maps=maps,
                    iters=config.iters, tol=config.tol, chunk=config.chunk,
                    device=dev, bucket=config.bucket)
                wall = time.perf_counter() - t0
                spent = sum(r.iterations for r in results)
                counters.dispatches += 1

                # per-member rehorizon retry ladder (mirrors run_online);
                # retries are solo cold solves on stretched horizons
                for k, r in zip(grp, results):
                    st, m = states[k], members[k]
                    tries = 0
                    while ((r.remaining_gbits > 1e-6
                            or not r.metrics.feasible) and tries < 2
                           and m["p"].coflow.n_flows > 0):
                        m["p"] = rehorizon(
                            m["p"], 2 * m["p"].n_slots,
                            path_slack=config.path_slack if tries == 0
                            else None)
                        t1 = time.perf_counter()
                        r = solver.solve_fast_warm(
                            m["p"], st.spec.objective, iters=config.iters,
                            tol=config.tol, chunk=config.chunk,
                            device=dev, bucket=config.bucket)
                        wall += time.perf_counter() - t1
                        spent += r.iterations
                        tries += 1
                        counters.retries += 1
                    if tries:
                        emit("retry", f"tenant={k} window={window} "
                                      f"tries={tries}")
                    if (fallback is not None
                            and (r.remaining_gbits > 1e-6
                                 or not r.metrics.feasible)
                            and m["p"].coflow.n_flows > 0):
                        # cheap-fallback tier: the retry ladder is
                        # exhausted, so hand the window to a baseline
                        # policy on a stretched horizon — milliseconds
                        # of greedy packing instead of another PDHG
                        # rung; accepted only if it certifies feasible
                        # and drains the demand
                        p_fb = rehorizon(m["p"], 2 * m["p"].n_slots)
                        t1 = time.perf_counter()
                        fb = fallback.solve(p_fb, st.spec.objective,
                                            device=dev)
                        wall += time.perf_counter() - t1
                        if (fb.metrics.feasible
                                and fb.remaining_gbits <= 1e-6):
                            m["p"], r = p_fb, fb
                            counters.fallbacks += 1
                            emit("fallback",
                                 f"tenant={k} window={window} "
                                 f"policy={config.fallback_policy}")
                    if config.verify_schedules or config.chaos:
                        # under chaos every post-failure schedule must
                        # carry a feasibility certificate — a degraded
                        # fabric is exactly when a stale plan would
                        # oversubscribe a dead link
                        cert = r.certificate or verify.check_schedule(
                            m["p"], r.schedule)
                        cert.assert_ok(f"tenant {k} window {window}")
                    m["result"] = r

                cost = config.cost.cost_s(iterations=spent,
                                          n_members=len(grp), wall_s=wall)
                control_free += cost
                key = members[grp[0]]["key"]
                emit("dispatch",
                     f"window={window} group={gi} "
                     f"members={','.join(str(k) for k in grp)} "
                     f"key={key} iters={spent} cost={cost:.6f}")
                for k in grp:
                    st = states[k]
                    for a in st.admitted:
                        req = requests[(k, a.coflow_id)]
                        req.status = "scheduled"
                        req.t_decision = control_free
                        lat = req.latency_s
                        latency.add(lat)
                        if config.chaos and states[k].fabric.degraded:
                            latency_degraded.add(lat)
                        if lat > config.slo_p99_s:
                            counters.slo_breaches += 1
                        emit("sched", f"tenant={k} coflow={a.coflow_id} "
                                      f"latency={lat:.6f}")
                if prefetch is not None:
                    prefetch.result()

            # -- data plane: execute each member's window prefix
            for k in ready:
                st, m = states[k], members[k]
                p, r = m["p"], m["result"]
                size, cid = m["size"], m["cid"]
                mask = m["deferred"]
                size_eff = np.where(mask, 0.0, size)
                D = st.spec.topo.slot_duration
                executed = (p.n_slots if last
                            else min(p.n_slots, st.window_slots))
                shipped, finish = flow_progress(p, r.schedule, executed)
                res_after = np.maximum(size_eff - shipped, 0.0)
                done = (res_after <= 1e-9) & ~mask
                for i in np.flatnonzero(done):
                    c = int(cid[i])
                    t_done = t_w + (finish[i] if np.isfinite(finish[i])
                                    else D * executed)
                    req = requests[(k, c)]
                    req.t_done = (t_done if np.isnan(req.t_done)
                                  else max(req.t_done, t_done))
                    st.unfinished[c] -= 1
                    if st.unfinished[c] == 0:
                        req.status = "done"
                        tres[k].n_done += 1
                        makespan = (req.t_done if np.isnan(makespan)
                                    else max(makespan, req.t_done))
                        tres[k].makespan_s = (
                            req.t_done if np.isnan(tres[k].makespan_s)
                            else max(tres[k].makespan_s, req.t_done))
                        emit("done", f"tenant={k} coflow={c} "
                                     f"t_done={req.t_done:.6f}")
                energy = prefix_energy(p, r.schedule, executed)
                total_energy += energy
                tres[k].energy_j += energy
                tres[k].shipped_gbits += float(
                    np.minimum(shipped, size_eff).sum())
                keep = ~done & ~mask
                st.c_src = m["src"][keep]
                st.c_dst = m["dst"][keep]
                st.c_res = res_after[keep]
                st.c_cid = cid[keep]
                st.c_prev = np.flatnonzero(keep).astype(np.int64)
                if config.chaos:
                    # park deferred flows (original residual size) until
                    # a boundary whose fabric reconnects their endpoints
                    st.d_src = m["src"][mask]
                    st.d_dst = m["dst"][mask]
                    st.d_res = size[mask]
                    st.d_cid = cid[mask]
                st.prev = r
                st.admitted = []
                emit("exec", f"window={window} tenant={k} slots={executed} "
                             f"shipped={float(np.minimum(shipped, size_eff).sum()):.6f} "
                             f"backlog={float(st.c_res.sum()):.6f}")
                if (config.chaos and st.recover_open is not None
                        and not st.d_res.size and r.metrics.feasible):
                    # episode closes at the first boundary whose
                    # certified re-plan carries no deferred demand
                    ttr = t_w - st.recover_open
                    robustness.recoveries.append(ttr)
                    emit("recover", f"tenant={k} ttr={ttr:.6f}")
                    st.recover_open = None

            counters.windows += 1
            window += 1
            if last:
                # the drain window ran every schedule to completion;
                # land the clock past the longest tail so makespan and
                # any follow-up windows stay on a monotone timeline
                tail = max((states[k].spec.topo.slot_duration
                            * (members[k]["p"].n_slots if last else 0)
                            for k in ready), default=0.0)
                clock.advance_to(max(t_w + window_s, t_w + tail))
            else:
                clock.advance_to(t_w + window_s)
            if (last and next_arr >= len(stream) and not waiting
                    and not any(st.ready for st in states)):
                break
    finally:
        if pool is not None:
            pool.shutdown(wait=True)

    disp1 = solver.dispatch_stats()
    counters.solver_dispatches = disp1.dispatches - disp0.dispatches
    counters.bucket_hits = disp1.shape_hits - disp0.shape_hits
    backlog = sum(st.backlog_gbits for st in states)
    backlog += sum(ta.arrival.coflow.total_gbits for ta in waiting)
    backlog += sum(stream[i].arrival.coflow.total_gbits
                   for i in range(next_arr, len(stream)))
    for k, st in enumerate(states):
        tres[k].backlog_gbits = st.backlog_gbits
    if config.chaos:
        # availability is trace-exact over the observed span, not a
        # function of the window grid the trace was replayed on
        t_end = clock.now()
        for st in states:
            robustness.span_s += t_end
            robustness.degraded_s += chaosmod.degraded_seconds(
                st.fabric.events, t_end)
            robustness.deferred_gbits += st.deferred_gbits
        robustness.events_applied = counters.chaos_events
    return ServiceResult(
        events=events,
        requests=sorted(requests.values(),
                        key=lambda r: (r.t_arrive, r.tenant, r.coflow_id)),
        tenants=tres, latency=latency, counters=counters,
        makespan_s=makespan, total_energy_j=total_energy,
        backlog_gbits=float(backlog), robustness=robustness,
        latency_degraded=latency_degraded)
