"""Online co-flow arrivals: seeded traces + rolling-horizon re-solves.

A copy of the reference `repro.core.arrivals`: traces are bitwise equal
to the reference's, and `run_online` re-solves each epoch through the
port's `solver.solve_fast_warm` on the card (or, with device="cpu", the
kernel's plain version), in either PDHG lowering (`backend=`)
(tests/test_torch_arrivals.py, tests/test_torch_coo.py).

The paper's MILP schedules a fixed co-flow set known at t = 0; a real
MapReduce cluster sees shuffle co-flows arrive continuously.  This
module turns the one-shot optimizer into a simulated online scheduler:

  * :func:`generate_trace` draws a deterministic, seeded arrival
    process ("poisson" / "burst" / "diurnal" inter-arrival families)
    whose co-flows are ordinary :class:`~repro_torch.core.traffic.CoflowSet`
    instances from the existing TrafficPattern placements;
  * :func:`run_online` is the rolling-horizon driver: at every epoch
    boundary it snapshots in-flight residual volumes from the executed
    prefix of the previous epoch's schedule, merges them with newly
    arrived co-flows into a fresh ScheduleProblem, and re-solves —
    warm-started from the previous epoch's PDHG state via
    ``solver.project_warm_start`` (``flow_map`` carries residual flows
    forward under their new indices; topology-shape changes or
    projection failures fall back to a cold solve);
  * :func:`interleave_traces` / :func:`merge_traces` merge per-tenant
    traces into one deterministic global stream — the request feed of
    the multi-tenant scheduler service (:mod:`repro_torch.service`).

Epoch lifecycle (see docs/ARCHITECTURE.md "The arrivals engine"):

  admit -> merge -> (project warm start) -> solve -> execute prefix ->
  snapshot residuals -> advance clock

Only the first ``epoch_s`` seconds of each epoch's schedule execute
before the next re-plan; once no future arrivals remain the final
schedule runs to completion, so a trace whose co-flows all arrive at
t = 0 degenerates to exactly one epoch whose metrics are the one-shot
``solve_fast`` numbers (tests/test_arrivals.py pins this).

Units follow the paper: sizes/volumes in Gbits, rates in Gbps, times
in seconds, energy in Joules.  Everything is deterministic for a fixed
(seed, spec, device); no global RNG state is read or written.
"""
from __future__ import annotations

import dataclasses
import time
import zlib

import numpy as np
import torch

from .. import device as _device
from . import chaos as chaosmod
from . import failures, solver, verify
from .timeslot import (TOL, ScheduleProblem, prefix_energy, rehorizon,
                       suggest_n_slots)
from .topology import Topology
from .traffic import CoflowSet, TrafficPattern, generate

FAMILIES = ("poisson", "burst", "diurnal")


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """One arrival-process configuration.

    ``mean_interarrival_s`` is the mean gap between consecutive co-flow
    arrivals for every family (burst/diurnal reshape the *pattern* of
    the gaps, not the long-run rate): "poisson" draws iid exponential
    gaps; "burst" releases co-flows in simultaneous groups of
    ``burst_size`` separated by exponential gaps of
    ``burst_size * mean_interarrival_s``; "diurnal" is an inhomogeneous
    Poisson process (thinning) whose rate swings by
    ``±diurnal_amplitude`` around the mean with period
    ``diurnal_period_s`` — the time-varying fog/PON workload regime of
    arXiv:1808.06113."""

    family: str = "poisson"
    n_coflows: int = 8
    mean_interarrival_s: float = 2.0
    burst_size: int = 4
    diurnal_period_s: float = 32.0
    diurnal_amplitude: float = 0.8

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"family {self.family!r} not in {FAMILIES}")
        if self.n_coflows < 1:
            raise ValueError("n_coflows must be >= 1")
        if self.mean_interarrival_s <= 0.0:
            raise ValueError("mean_interarrival_s must be > 0")
        if self.burst_size < 1:
            raise ValueError("burst_size must be >= 1")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1)")


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One timestamped co-flow."""

    t_arrive: float
    coflow: CoflowSet
    coflow_id: int


def _arrival_times(spec: ArrivalSpec, rng: np.random.Generator) -> np.ndarray:
    n = spec.n_coflows
    mean = spec.mean_interarrival_s
    if spec.family == "poisson":
        t = np.cumsum(rng.exponential(mean, size=n))
    elif spec.family == "burst":
        n_bursts = -(-n // spec.burst_size)
        burst_t = np.cumsum(rng.exponential(mean * spec.burst_size,
                                            size=n_bursts))
        t = np.repeat(burst_t, spec.burst_size)[:n]
    else:                                   # diurnal (thinning)
        lam0 = 1.0 / mean
        lam_max = lam0 * (1.0 + spec.diurnal_amplitude)
        out, clock = [], 0.0
        while len(out) < n:
            clock += rng.exponential(1.0 / lam_max)
            lam = lam0 * (1.0 + spec.diurnal_amplitude
                          * np.sin(2.0 * np.pi * clock
                                   / spec.diurnal_period_s))
            if rng.uniform() * lam_max <= lam:
                out.append(clock)
        t = np.asarray(out)
    return t - t[0]                         # first co-flow arrives at t = 0


def generate_trace(topo: Topology, pat: TrafficPattern, spec: ArrivalSpec,
                   seed: int = 0) -> list[Arrival]:
    """Draw one deterministic arrival trace.

    Arrival times come from the spec's inter-arrival family; each
    co-flow is an independent ``traffic.generate`` draw of `pat` (its
    own placement permutation and size skew).  The (seed, family) pair
    fully determines the trace — sweeps reuse the same seed vector they
    use everywhere else."""
    tag = zlib.crc32(spec.family.encode())
    rng_t = np.random.default_rng([seed, tag, 0])
    rng_c = np.random.default_rng([seed, tag, 1])
    times = _arrival_times(spec, rng_t)
    cf_seeds = rng_c.integers(0, 2**31 - 1, size=spec.n_coflows)
    return [Arrival(float(t), generate(topo, pat, int(s)), i)
            for i, (t, s) in enumerate(zip(times, cf_seeds))]


def trace_at_t0(coflows: list[CoflowSet]) -> list[Arrival]:
    """All co-flows available at t = 0 (the paper's offline assumption);
    with one epoch the driver then reproduces one-shot solve_fast."""
    return [Arrival(0.0, cf, i) for i, cf in enumerate(coflows)]


# ---------------------------------------------------------------------------
# Multi-tenant trace interleaving (the scheduler service, repro_torch.service)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantArrival:
    """One arrival tagged with the tenant (trace index) that owns it."""

    tenant: int
    arrival: Arrival


def interleave_traces(traces: list[list[Arrival]]) -> list[TenantArrival]:
    """Merge per-tenant arrival traces into one global, deterministic
    event stream ordered by (t_arrive, tenant index, coflow_id).

    Simultaneous arrivals — common with "burst" families, and guaranteed
    at t = 0 where every trace places its first co-flow — tie-break on
    the tenant index and then the per-tenant coflow_id, so the stream
    order (and everything the service loop derives from it: admission
    order, shed decisions, event logs) is a pure function of the traces.
    Per-tenant coflow_ids are preserved; (tenant, coflow_id) is the
    globally unique request key."""
    out = [TenantArrival(k, a) for k, tr in enumerate(traces) for a in tr]
    out.sort(key=lambda ta: (ta.arrival.t_arrive, ta.tenant,
                             ta.arrival.coflow_id))
    return out


def merge_traces(traces: list[list[Arrival]]) -> list[Arrival]:
    """Flatten tenant traces into one `run_online`-ready trace.

    The rolling-horizon driver keys its co-flow accounting by coflow_id,
    so the interleaved stream is renumbered globally (in interleaved
    order); use this to score a whole multi-tenant workload as a single
    shared-fabric run_online trace (every tenant's co-flows compete for
    the same topology)."""
    return [Arrival(ta.arrival.t_arrive, ta.arrival.coflow, i)
            for i, ta in enumerate(interleave_traces(traces))]


# ---------------------------------------------------------------------------
# Rolling-horizon driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EpochStats:
    """One epoch of the rolling horizon (all quantities paper units)."""

    index: int
    t_start: float            # wall-clock start of the epoch, s
    n_admitted: int           # co-flows admitted at this boundary
    n_flows: int              # flows in the merged epoch problem
    demand_gbits: float       # merged residual + new demand
    n_slots: int              # planning horizon of the epoch problem
    executed_slots: int       # slots that actually ran before re-planning
    shipped_gbits: float      # Gbits delivered inside the executed prefix
    backlog_gbits: float      # residual demand carried to the next epoch
    energy_j: float           # exact eq. 19-22 energy of the executed prefix
    iterations: int           # PDHG iterations spent (incl. retries)
    warm: bool                # PDHG really started from a projected state
                              # (False when the projection fell back cold)
    feasible: bool
    max_violation: float
    lp_primal_residual: float
    solve_s: float            # wall time of the epoch solve(s)
    # chaos-replay bookkeeping (all zero/default on a healthy run)
    chaos_events: int = 0     # fail/repair events applied at this boundary
    degraded: bool = False    # fabric was degraded while this epoch ran
    stranded_gbits: float = 0.0   # carried volume whose planned paths died
                                  # at this boundary (re-routed by the
                                  # warm-start projection)
    deferred_gbits: float = 0.0   # demand parked as deferred-by-failure
                                  # (endpoints disconnected) this epoch
    certified: bool = True    # core.verify certificate of the epoch
                              # schedule (checked on chaos runs)


@dataclasses.dataclass
class CoflowStats:
    coflow_id: int
    t_arrive: float
    gbits: float
    n_flows: int
    t_done: float             # nan while unfinished

    @property
    def response_s(self) -> float:
        return self.t_done - self.t_arrive


@dataclasses.dataclass
class OnlineResult:
    """Aggregate outcome of one rolling-horizon run."""

    epochs: list[EpochStats]
    coflows: list[CoflowStats]
    makespan_s: float         # last co-flow completion (nan if none finished)
    total_energy_j: float     # sum of executed-prefix energies
    mean_response_s: float    # mean t_done - t_arrive over finished
                              # co-flows (nan when none finished)
    backlog_gbits: float      # unserved demand when the driver stopped:
                              # carried residuals + never-admitted arrivals
                              # (nonzero only when max_epochs truncated)
    total_iterations: int
    # the final epoch's solver output — with a single epoch this carries
    # exactly the one-shot solve_fast result for the merged co-flow set
    last_result: solver.FastPathResult | None = None
    # chaos-replay outcome (defaults on a healthy run; see docs/CHAOS.md)
    availability: float = 1.0     # fraction of [0, makespan] with full
                                  # admissible capacity (trace-exact)
    stranded_gbits: float = 0.0   # total carried volume re-routed after
                                  # its decomposed paths died
    deferred_failure_gbits: float = 0.0   # demand still parked as
                                  # deferred-by-failure when the run ended
                                  # (endpoints never reconnected)
    recoveries: list[float] = dataclasses.field(default_factory=list)
                                  # time-to-recover per episode, seconds
    chaos_log: list[str] = dataclasses.field(default_factory=list)
                                  # canonical replay log lines (byte-
                                  # stable per seed and device)

    @property
    def n_epochs(self) -> int:
        return len(self.epochs)

    @property
    def warm_iterations(self) -> float:
        """Mean PDHG iterations per warm-started epoch (0 if none)."""
        its = [e.iterations for e in self.epochs if e.warm]
        return float(np.mean(its)) if its else 0.0


def flow_progress(p: ScheduleProblem, x: np.ndarray, t_end: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(shipped, finish_s) per flow over the executed prefix.

    `shipped[f]` is the net injection at flow f's source in slots
    [0, t_end); `finish_s[f]` is the eq. 39-style completion offset
    (slot start + the in-slot transmission time of the last link the
    flow uses), or nan if the flow does not finish inside the prefix."""
    F, E, W, T = p.shape_x
    D = p.topo.slot_duration
    shipped = np.zeros(F)
    finish = np.full(F, np.nan)
    if F == 0 or t_end == 0:
        return shipped, finish
    psi = x.sum(axis=0)                                # (E, W, T)
    with np.errstate(divide="ignore", invalid="ignore"):
        tx_time = np.where(psi > TOL,
                           psi / np.maximum(p.topo.cap[:, :, None], 1e-30),
                           0.0)
    for f in range(F):
        s = p.coflow.src[f]
        out = x[f, p.e_src == s].sum(axis=(0, 1))      # (T,)
        inn = x[f, p.e_dst == s].sum(axis=(0, 1))
        cum = np.cumsum(out - inn)
        shipped[f] = float(cum[t_end - 1])
        need = float(p.coflow.size[f])
        done = np.flatnonzero(cum >= need - 1e-6)
        if done.size and done[0] < t_end:
            t = int(done[0])
            used = x[f, :, :, t] > TOL
            in_slot = float(tx_time[:, :, t][used].max(initial=0.0))
            finish[f] = D * t + in_slot
    return shipped, finish


def run_online(topo: Topology, trace: list[Arrival],
               objective: str = "energy", *, epoch_s: float | None = None,
               rho: float = 8.0, q_weight: float = 100.0,
               path_slack: int | None = 2, iters: int = 3000,
               tol: float | None = 2e-3, chunk: int = 250,
               backend: str = "xla",
               device: str | torch.device = "cuda", warm: bool = True,
               max_epochs: int = 128,
               chaos: list[chaosmod.ChaosEvent] | None = None,
               fallback_policy: str | None = None) -> OnlineResult:
    """Simulate rolling-horizon scheduling of an arrival trace.

    Every epoch re-plans *all* outstanding work (carried residuals +
    co-flows that arrived since the last boundary) over a fresh
    suggest_n_slots horizon, then executes only the first `epoch_s`
    seconds (default 4 slot durations) before the next re-plan; the
    final epoch — no future arrivals left — runs its schedule to
    completion.  With ``warm=True`` (default) each re-solve starts from
    the previous epoch's projected PDHG state (cold solve on the first
    epoch, after a topology-shape change, or if the projection fails).

    `chaos` replays a core.chaos failure/repair event trace: events are
    applied at epoch boundaries, carried flows whose decomposed paths
    died are re-routed through the warm-start projection (their volume
    reported as stranded), demand on fully-disconnected endpoints is
    parked as *deferred-by-failure* (re-admitted once the fabric heals,
    never silently shed), and every epoch schedule is certified via
    core.verify.  `fallback_policy` names a core.policies baseline that
    takes the epoch when the rehorizon retry ladder exhausts (accepted
    only if it certifies feasible and drains the demand) — the service
    loop's hardened ladder; None (default) keeps the retry-only
    behavior.  It is a scheduling tier, taken on those conditions only:
    an error of the solve itself propagates.

    `backend` is the PDHG lowering of every epoch's solve ("xla", the
    default as in the reference, or "pallas"; see solver.solve_lp), and
    `device` where its bursts run: "cuda" (default; the CUDA kernel,
    raising without a card) or "cpu" (its plain version).

    Returns an OnlineResult; per-epoch energies are exact paper-model
    numbers for the executed prefixes, and co-flow completion times use
    the eq. 39 in-slot transmission-time convention."""
    if objective not in ("energy", "time"):
        raise ValueError(f"objective {objective!r} not in ('energy', 'time')")
    dev = _device.resolve(device)
    solver._check_backend(backend)
    D = topo.slot_duration
    if epoch_s is None:
        epoch_s = 4.0 * D
    epoch_slots = max(1, int(round(epoch_s / D)))
    pending = sorted(trace, key=lambda a: (a.t_arrive, a.coflow_id))
    stats = {a.coflow_id: CoflowStats(a.coflow_id, a.t_arrive,
                                      a.coflow.total_gbits,
                                      a.coflow.n_flows, np.nan)
             for a in pending}
    unfinished = {a.coflow_id: int(a.coflow.n_flows) for a in pending}

    fabric = chaosmod.FabricState(topo, chaos) if chaos else None
    if fallback_policy is not None:
        from . import policies as policy_zoo
        fallback = policy_zoo.get(fallback_policy)
    else:
        fallback = None
    chaos_log: list[str] = []
    recoveries: list[float] = []
    recover_open: float | None = None
    stranded_total = 0.0

    # carried residual flows (flat arrays, one entry per unfinished flow)
    c_src = np.zeros(0, np.int64)
    c_dst = np.zeros(0, np.int64)
    c_res = np.zeros(0, np.float64)
    c_cid = np.zeros(0, np.int64)          # owning co-flow id
    c_prev = np.zeros(0, np.int64)         # index in the previous problem
    # deferred-by-failure flows: endpoints disconnected by an active
    # failure; they re-enter the candidate set at every boundary and go
    # back to the pool while still unroutable (always empty chaos-off)
    d_src = np.zeros(0, np.int64)
    d_dst = np.zeros(0, np.int64)
    d_res = np.zeros(0, np.float64)
    d_cid = np.zeros(0, np.int64)

    epochs: list[EpochStats] = []
    prev: solver.FastPathResult | None = None
    t_now = 0.0
    total_energy = 0.0
    while (pending or c_res.size or d_res.size) and len(epochs) < max_epochs:
        cap_changed = False
        epoch_stranded = 0.0
        if fabric is not None:
            applied, cap_changed = fabric.advance_to(t_now)
            for ev in applied:
                chaos_log.append(f"t={t_now:.6f} {ev.kind} "
                                 f"event={ev.event_id} "
                                 f"scenario={ev.scenario.name}")
        etopo = fabric.topo if fabric is not None else topo
        n_chaos = len(applied) if fabric is not None else 0

        admitted = []
        while pending and pending[0].t_arrive <= t_now + 1e-9:
            admitted.append(pending.pop(0))
        new_src = [a.coflow.src for a in admitted]
        new_dst = [a.coflow.dst for a in admitted]
        new_size = [a.coflow.size for a in admitted]
        new_cid = [np.full(a.coflow.n_flows, a.coflow_id, np.int64)
                   for a in admitted]
        src = np.concatenate([c_src, d_src] + new_src).astype(np.int64)
        dst = np.concatenate([c_dst, d_dst] + new_dst).astype(np.int64)
        size = np.concatenate([c_res, d_res] + new_size).astype(np.float64)
        cid = np.concatenate([c_cid, d_cid] + new_cid).astype(np.int64)
        flow_map = np.concatenate(
            [c_prev, np.full(len(src) - len(c_prev), -1, np.int64)])

        cf = CoflowSet(src, dst, size, topo.n_vertices)
        p = ScheduleProblem(etopo, cf, n_slots=suggest_n_slots(etopo, cf,
                                                               rho=rho),
                            rho=rho, q_weight=q_weight,
                            path_slack=path_slack)
        # park flows the active failures fully disconnected: they enter
        # the epoch problem with zero demand (degrade_problem's trick —
        # flow indexing survives for the warm-start projection) and
        # their residual waits in the deferred pool for a repair
        deferred_mask = np.zeros(len(src), dtype=bool)
        if fabric is not None and len(src) and fabric.degraded:
            deferred_mask = ~failures.routable_flows(p) & (size > 1e-9)
            if deferred_mask.any():
                cf = CoflowSet(src, dst,
                               np.where(deferred_mask, 0.0, size),
                               topo.n_vertices)
                p = ScheduleProblem(
                    etopo, cf, n_slots=suggest_n_slots(etopo, cf, rho=rho),
                    rho=rho, q_weight=q_weight, path_slack=path_slack)
                for c in np.unique(cid[deferred_mask]):
                    g = float(size[deferred_mask & (cid == c)].sum())
                    chaos_log.append(f"t={t_now:.6f} deferfail "
                                     f"coflow={int(c)} gbits={g:.6f}")
        size_eff = np.where(deferred_mask, 0.0, size)

        t0 = time.perf_counter()
        # a zero-flow previous epoch has only an all-zero state to offer
        # — projecting it is a cold start in disguise, so don't call it warm
        use_warm = (warm and prev is not None and len(src) > 0
                    and prev.schedule.shape[0] > 0)
        if fabric is not None and use_warm and cap_changed:
            sv = solver.stranded_volume(prev, p, flow_map=flow_map)
            epoch_stranded = float(sv.sum())
            if epoch_stranded > 1e-9:
                stranded_total += epoch_stranded
                chaos_log.append(f"t={t_now:.6f} strand "
                                 f"flows={int((sv > 1e-9).sum())} "
                                 f"gbits={epoch_stranded:.6f}")
        if fabric is not None and recover_open is None \
                and (deferred_mask.any() or epoch_stranded > 1e-9):
            # measure from the failure event itself when this boundary
            # applied one — TTR includes the detection lag to the next
            # boundary, not just the re-plan
            fail_t = min((ev.t for ev in applied if ev.kind == "fail"),
                         default=t_now)
            recover_open = min(fail_t, t_now)
        r = solver.solve_fast_warm(p, objective,
                                   warm=prev if use_warm else None,
                                   flow_map=flow_map if use_warm else None,
                                   iters=iters, tol=tol, chunk=chunk,
                                   backend=backend, device=dev)
        # what actually ran, not what was attempted: solve_fast_warm
        # silently falls back to cold when the projection is unusable
        warm_ran = r.warm_started
        spent = r.iterations
        # horizon-doubling retry (mirrors the sweep's ladder) when the
        # packer could not finish in-horizon; cold — the stretched
        # horizon changes the LP's capacity rows wholesale
        tries = 0
        while (r.remaining_gbits > 1e-6 or not r.metrics.feasible) \
                and tries < 2 and len(src) > 0:
            # rehorizon shares the derived arrays (and the cached LP
            # structure) with the epoch problem; only the final pruning-
            # drop retry rebuilds from scratch
            p = rehorizon(p, 2 * p.n_slots,
                          path_slack=path_slack if tries == 0 else None)
            r = solver.solve_fast_warm(p, objective, iters=iters, tol=tol,
                                       chunk=chunk, backend=backend,
                                       device=dev)
            spent += r.iterations
            tries += 1
        if (fallback is not None and len(src) > 0
                and (r.remaining_gbits > 1e-6 or not r.metrics.feasible)):
            # final ladder rung (mirrors the service loop): hand the
            # epoch to a certified baseline policy on a stretched
            # horizon; accepted only if it drains the demand feasibly
            p_fb = rehorizon(p, 2 * p.n_slots)
            fb = fallback.solve(p_fb, objective, backend=backend,
                                device=dev)
            if fb.metrics.feasible and fb.remaining_gbits <= 1e-6:
                p, r = p_fb, fb
                tries += 1
                chaos_log.append(f"t={t_now:.6f} fallback "
                                 f"policy={fallback_policy}")
        # an epoch that needed cold retries is not a clean warm sample —
        # its iteration count would attribute the retries' cold work to
        # the warm-start machinery (warm_iterations in the sweep CSV)
        warm_ran = warm_ran and tries == 0
        solve_s = time.perf_counter() - t0
        certified = True
        if fabric is not None and len(src) > 0:
            cert = r.certificate or verify.check_schedule(p, r.schedule)
            certified = bool(cert.ok)

        # while future chaos events exist keep epochs short — a storm
        # landing mid-run must be seen at the next boundary, not skipped
        # by a drain-to-completion epoch; the run only drains once no
        # event can change the fabric again
        more_chaos = (fabric is not None
                      and fabric.next_event_t is not None)
        last = not pending and not more_chaos
        executed = p.n_slots if last else min(p.n_slots, epoch_slots)
        shipped, finish = flow_progress(p, r.schedule, executed)
        res_after = np.maximum(size_eff - shipped, 0.0)
        done = (res_after <= 1e-9) & ~deferred_mask
        for i in np.flatnonzero(done):
            cstat = stats[int(cid[i])]
            t_done = t_now + (finish[i] if np.isfinite(finish[i])
                              else D * executed)
            cstat.t_done = (t_done if np.isnan(cstat.t_done)
                            else max(cstat.t_done, t_done))
            unfinished[int(cid[i])] -= 1
        energy = prefix_energy(p, r.schedule, executed)
        total_energy += energy
        epochs.append(EpochStats(
            index=len(epochs), t_start=t_now, n_admitted=len(admitted),
            n_flows=len(src), demand_gbits=float(size_eff.sum()),
            n_slots=p.n_slots, executed_slots=executed,
            shipped_gbits=float(np.minimum(shipped, size_eff).sum()),
            backlog_gbits=float(res_after.sum()), energy_j=energy,
            iterations=spent, warm=warm_ran,
            feasible=bool(r.metrics.feasible),
            max_violation=float(r.metrics.max_violation),
            lp_primal_residual=float(r.lp_primal_residual),
            solve_s=solve_s,
            chaos_events=n_chaos,
            degraded=fabric.degraded if fabric is not None else False,
            stranded_gbits=epoch_stranded,
            deferred_gbits=float(size[deferred_mask].sum()),
            certified=certified))

        keep = ~done & ~deferred_mask
        c_src, c_dst = src[keep], dst[keep]
        c_res, c_cid = res_after[keep], cid[keep]
        c_prev = np.flatnonzero(keep).astype(np.int64)
        d_src, d_dst = src[deferred_mask], dst[deferred_mask]
        d_res, d_cid = size[deferred_mask], cid[deferred_mask]
        prev = r
        # the episode closes at the boundary whose certified re-plan
        # carried no deferred demand — service restored, even if the
        # re-routed schedule still has slots left to run
        if (fabric is not None and recover_open is not None
                and not d_res.size and certified):
            recoveries.append(t_now - recover_open)
            chaos_log.append(f"t={t_now:.6f} recover "
                             f"ttr={recoveries[-1]:.6f}")
            recover_open = None
        t_now += D * executed
        if not c_res.size and not d_res.size and pending \
                and pending[0].t_arrive > t_now + 1e-9:
            # idle gap: jump straight to the epoch boundary that admits
            # the next arrival instead of spinning empty epochs
            gap = pending[0].t_arrive - t_now
            t_now += epoch_s * np.ceil(gap / epoch_s - 1e-9)
        elif (fabric is not None and d_res.size and not c_res.size
              and not pending):
            # only deferred-by-failure demand remains: wait for the
            # repair that reconnects it, or stop if none can ever come
            nxt = fabric.next_event_t
            if nxt is None:
                break
            if nxt > t_now + 1e-9:
                gap = nxt - t_now
                t_now += epoch_s * np.ceil(gap / epoch_s - 1e-9)

    finished = [c for c in stats.values() if np.isfinite(c.t_done)
                and unfinished[c.coflow_id] == 0]
    responses = [c.response_s for c in finished]
    # unserved demand when the driver stopped: carried residuals plus —
    # if max_epochs truncated the run — co-flows never even admitted;
    # deferred-by-failure demand is accounted separately (never shed)
    backlog = float(c_res.sum()) + sum(a.coflow.total_gbits
                                       for a in pending)
    return OnlineResult(
        epochs=epochs,
        coflows=sorted(stats.values(), key=lambda c: c.coflow_id),
        makespan_s=max((c.t_done for c in finished), default=np.nan),
        total_energy_j=total_energy,
        mean_response_s=float(np.mean(responses)) if responses else np.nan,
        backlog_gbits=backlog,
        total_iterations=int(sum(e.iterations for e in epochs)),
        last_result=prev,
        availability=chaosmod.availability(chaos or [], t_now),
        stranded_gbits=stranded_total,
        deferred_failure_gbits=float(d_res.sum()),
        recoveries=recoveries,
        chaos_log=chaos_log)
