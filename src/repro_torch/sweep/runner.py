"""Sweep driver: topology x objective x pattern x seeds (x failures x
arrivals), on the card.

The port of the reference's repro.sweep.runner.  Per
(topology, pattern): one `generate_batch` builds the seed vector of
co-flow sets; per objective the whole vector solves in a few stacked
adaptive PDHG dispatches (core.solver.solve_fast_batch, every burst the
CUDA kernel on device="cuda").  Metrics are always the exact paper-model
numbers from core.timeslot.evaluate — never LP estimates.  A
deterministic subsample (the cheapest instances first) can be re-solved
with the core.oracle MILP, recording the optimality gap of the fast path
against the exact branch-and-cut schedule.

With `SweepSpec.failures` set (CLI `--failures`), every healthy cell
additionally re-solves under degraded fabrics: per seed a deterministic
scenario is drawn (core.failures.sample), the degraded instance keeps
the healthy edge indexing, and the whole failure ensemble re-solves in
one warm-started stacked dispatch (core.solver.solve_fast_ensemble)
seeded from the healthy solutions.  Records carry the capacity
degradation ratio and survivability (served / offered Gbits).

With `SweepSpec.policies` set (CLI `--policy`), every healthy AND
failure cell additionally runs each named baseline scheduler from
core.policies next to the LP.  Policy rows carry `policy` (the LP's
own rows say "lp") and `gap_vs_lp` — the shared LP-objective
functional (core.policies.lp_cost) evaluated on the policy's packed
schedule over the LP's; every policy schedule is certified by
core.verify.check_schedule before it is recorded.

With `SweepSpec.placement_search` set (CLI `--placement-search`), each
topology x objective x seed optimizes the task placement jointly with
the routing (repro_torch.search, one stacked dispatch a generation) and
records the optimized row beside the three fixed placements.

With `SweepSpec.arrivals` set (CLI `--arrivals`), every cell also runs,
per family and seed, a deterministic arrival trace through the
rolling-horizon driver (core.arrivals.run_online, warm-started epoch
re-solves); one record summarizes each trace.  With `SweepSpec.chaos`
(CLI `--chaos`), per preset and seed a poisson trace runs while a
seeded failure/repair event trace (core.chaos) degrades the fabric, the
retry ladder ending in the certified "scf" fallback tier, as in the
reference's chaos cells.

Records keep every column of the reference's SweepRecord.  `backend`
reads the PDHG lowering that ran (`SweepSpec.backend`): "xla", the
default as in the reference, whose rows are the reference's default
rows, or "pallas", whose rows line up with the reference's `--backend
pallas` rows.  With mesh > 1 every LP fast-path solve is
row-sharded across that many torch.distributed ranks (core.solver
shards=mesh), each rank running the whole sweep; `python -m
repro_torch.sweep --mesh N` under `torchrun --nproc-per-node N` sets the
ranks up.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from .. import search
from ..core import (arrivals, failures, oracle, solver, timeslot,
                    topology, traffic)
from ..core import chaos as chaosmod
from ..core import policies as policy_zoo

# user-facing objective name -> core.solver/oracle internal name
OBJECTIVES = {"energy": "energy", "completion": "time"}

ALL_TOPOS = tuple(topology.BUILDERS)

@dataclasses.dataclass
class SweepSpec:
    topos: tuple[str, ...] = ALL_TOPOS
    objectives: tuple[str, ...] = ("energy", "completion")
    patterns: tuple[str, ...] = ("uniform", "skew", "packed")
    seeds: tuple[int, ...] = tuple(range(8))
    # failure presets (core.failures.SCENARIOS names); per preset each seed
    # draws one deterministic scenario and re-solves warm-started
    failures: tuple[str, ...] = ()
    # baseline policies (core.policies.POLICIES names) to run next to the
    # LP in every healthy and failure cell, recording gap_vs_lp rows
    policies: tuple[str, ...] = ()
    # placement-search methods (repro_torch.search.METHODS): per topology
    # x objective x seed, jointly optimize task placement + routing and
    # record optimized-vs-fixed-placement gain rows
    placement_search: tuple[str, ...] = ()
    placement_generations: int = 6    # move rounds per search run
    placement_population: int = 8     # candidates per stacked dispatch
    # online-arrival families (core.arrivals.FAMILIES); per family each seed
    # draws one deterministic trace and runs the rolling-horizon driver
    # (warm-started epoch re-solves) instead of a one-shot solve
    arrivals: tuple[str, ...] = ()
    arrival_coflows: int = 5          # co-flows per trace
    arrival_mean_s: float = 2.0       # mean inter-arrival gap, seconds
    epoch_s: float | None = None      # re-plan period (None = 4 slots)
    # chaos presets (core.chaos.PRESETS names); per preset each seed
    # replays a deterministic failure/repair event trace under a
    # rolling-horizon poisson run (mid-run degradation, stranded-flow
    # recovery, deferred-by-failure accounting — see docs/CHAOS.md)
    chaos: tuple[str, ...] = ()
    total_gbits: float = 30.0
    n_map: int = 10
    n_reduce: int = 6
    n_slots: int | None = None        # None => timeslot.suggest_n_slots
    rho: float = 8.0
    iters: int = 3000
    # loose LP tolerance: the packed schedule is re-scored with the exact
    # paper model regardless, and packing is robust to ~1e-3 residuals
    tol: float = 2e-3
    # PDHG lowering: "xla" (COO in the reference's summation order, the
    # default as in the reference) or "pallas" (blocked ELL); see
    # core.solver.solve_lp
    backend: str = "xla"
    # scale knobs (pallas only): precision="bf16" stores the PDHG
    # iterates in bfloat16 between iterations (fp32 arithmetic); mesh > 1
    # row-shards each PDHG dispatch across that many torch.distributed
    # ranks.  Applied to the LP fast path (healthy + failure cells);
    # baseline policies, placement search and rolling-horizon runs stay
    # fp32 on one device, as in the reference
    mesh: int = 1
    precision: str = "fp32"
    path_slack: int | None = 2        # near-shortest route pruning; None = off
    oracle_check: int = 0             # instances to spot-check vs the MILP
    oracle_time_limit: float = 60.0
    # print a build/solve wall-time split per grid cell (problem + LP
    # assembly vs PDHG/packing), with structure-cache hit/miss deltas
    # from core.solver.build_cache_stats()
    profile: bool = False
    # where the PDHG bursts run: "cuda" (default; raises without a card)
    # or "cpu" (the kernel's plain PyTorch version)
    device: str = "cuda"

    def validate(self) -> None:
        for t in self.topos:
            if t not in topology.BUILDERS:
                raise ValueError(f"unknown topology {t!r}; "
                                 f"have {sorted(topology.BUILDERS)}")
            n_srv = len(topology.build(t).task_servers)
            if self.n_map + self.n_reduce > n_srv:
                raise ValueError(
                    f"{t}: need {self.n_map + self.n_reduce} task servers "
                    f"for {self.n_map}x{self.n_reduce} tasks, have {n_srv}")
        for o in self.objectives:
            if o not in OBJECTIVES:
                raise ValueError(f"unknown objective {o!r}; "
                                 f"have {sorted(OBJECTIVES)}")
        for pt in self.patterns:
            if pt not in traffic.PATTERNS:
                raise ValueError(f"unknown pattern {pt!r}; "
                                 f"have {sorted(traffic.PATTERNS)}")
        if self.backend not in solver.BACKENDS:
            raise ValueError(f"unknown solver backend {self.backend!r}; "
                             f"have {solver.BACKENDS}")
        # mesh/precision constraints (pallas-only) mirror the solver's
        solver._check_scale_opts(self.backend, self.mesh, self.precision)
        for fl in self.failures:
            if fl not in failures.SCENARIOS or fl == "none":
                # "none" is rejected too: its records would carry
                # failure="none" and be misfiled as healthy rows in the
                # report — an empty `failures` tuple is the healthy run
                raise ValueError(f"unknown failure preset {fl!r}; "
                                 f"have {sorted(k for k in failures.SCENARIOS if k != 'none')}")
        for fam in self.arrivals:
            if fam not in arrivals.FAMILIES:
                raise ValueError(f"unknown arrival family {fam!r}; "
                                 f"have {sorted(arrivals.FAMILIES)}")
        for cz in self.chaos:
            if cz not in chaosmod.PRESETS:
                raise ValueError(f"unknown chaos preset {cz!r}; "
                                 f"have {sorted(chaosmod.PRESETS)}")
        for pol in self.policies:
            if pol not in policy_zoo.POLICIES:
                raise ValueError(f"unknown policy {pol!r}; "
                                 f"have {sorted(policy_zoo.POLICIES)}")
        for method in self.placement_search:
            if method not in search.METHODS:
                raise ValueError(f"unknown placement-search method "
                                 f"{method!r}; have {search.METHODS}")
        if self.placement_search:
            # fail before solving anything, not inside the search loop
            search.SearchConfig(
                generations=self.placement_generations,
                population=self.placement_population,
                backend=self.backend, device=self.device).validate()


@dataclasses.dataclass
class SweepRecord:
    topo: str
    objective: str                    # "energy" | "completion"
    pattern: str
    seed: int
    n_flows: int
    total_gbits: float
    n_slots: int
    energy_j: float
    completion_s: float
    feasible: bool
    max_violation: float
    lp_lower_bound: float
    lp_primal_residual: float
    remaining_gbits: float
    solve_s: float                    # amortized wall time per instance
    failure: str = "none"             # failure preset ("none" = healthy)
    degradation_ratio: float = 0.0    # fraction of aggregate Gbps lost
    survivability: float = 1.0        # served / offered Gbits
    backend: str = "xla"              # PDHG lowering that produced this row
    # online-arrival rows (core.arrivals rolling-horizon driver);
    # arrivals == "none" marks an offline (one-shot) row
    arrivals: str = "none"            # arrival-process family
    epochs: int = 0                   # rolling-horizon epochs run
    mean_response_s: float = 0.0      # mean co-flow (t_done - t_arrive), s
    backlog_gbits: float = 0.0        # demand unserved when the run ended
    warm_iterations: float = 0.0      # mean PDHG iters per warm epoch
    oracle_energy_j: float | None = None
    oracle_completion_s: float | None = None
    oracle_gap: float | None = None   # (fast - oracle) / oracle, primary metric
    oracle_mip_gap: float | None = None
    # which scheduler produced this row: "lp" (the fast path) or a
    # core.policies baseline name; policy rows carry the shared-functional
    # optimality ratio vs the cell's LP solve (core.policies.gap_vs_lp)
    policy: str = "lp"
    gap_vs_lp: float = 1.0
    # placement-search rows (repro_torch.search): "none" marks ordinary
    # rows.  A search run emits one optimized row (pattern="optimized")
    # plus one row per fixed baseline placement (pattern="spread"/
    # "packed"/"local"), all tagged with the method.  placement_gain is
    # the best FIXED placement's primary metric over THIS row's
    placement_search: str = "none"
    placement_gain: float = 1.0
    # chaos-replay rows (core.chaos event traces over a rolling-horizon
    # run); chaos == "none" marks a healthy row.  availability is the
    # trace-exact fraction of the run with full admissible capacity;
    # recover_s is the mean time-to-recover over the row's episodes
    # (NaN when no failure ever stranded or deferred demand);
    # deferred_gbits is demand still deferred-by-failure at exit
    chaos: str = "none"
    availability: float = 1.0
    stranded_gbits: float = 0.0
    recover_s: float = float("nan")
    deferred_gbits: float = 0.0

    @property
    def primary(self) -> float:
        return self.energy_j if self.objective == "energy" else self.completion_s


def _profile_line(say, label: str, snap, wall_s: float) -> None:
    """One --profile line: LP-assembly vs solve split for a finished cell
    (`snap` is the build_cache_stats snapshot taken before the cell)."""
    d = solver.build_cache_stats()
    build_s = ((d.structure_s + d.fill_s + d.ell_s)
               - (snap.structure_s + snap.fill_s + snap.ell_s))
    say(f"    profile {label}: build {build_s * 1e3:7.1f} ms "
        f"(structure {d.structure_hits - snap.structure_hits} hit"
        f"/{d.structure_misses - snap.structure_misses} miss, "
        f"ell {d.ell_hits - snap.ell_hits} hit"
        f"/{d.ell_misses - snap.ell_misses} miss) | "
        f"solve {(wall_s - build_s) * 1e3:8.1f} ms | "
        f"total {wall_s * 1e3:8.1f} ms")


def _problems_for(topo, pat: traffic.TrafficPattern, spec: SweepSpec):
    coflows = traffic.generate_batch(topo, pat, spec.seeds)
    probs = []
    for cf in coflows:
        T = spec.n_slots or timeslot.suggest_n_slots(topo, cf, rho=spec.rho)
        probs.append(timeslot.ScheduleProblem(topo, cf, n_slots=T,
                                              rho=spec.rho,
                                              path_slack=spec.path_slack))
    return probs


def _retry_unfinished(probs, results, internal_obj: str, spec: SweepSpec):
    """Per-instance horizon-doubling retry for any schedule the greedy
    packer could not finish inside the horizon (in place).  Retried
    problems come from timeslot.rehorizon, which reuses the original
    instance's derived arrays (and thereby its cached LP structure)
    instead of re-deriving them — only the last-resort retry that drops
    route pruning pays a full rebuild."""
    for i, (p, r) in enumerate(zip(probs, results)):
        tries = 0
        while (r.remaining_gbits > 1e-6 or not r.metrics.feasible) and tries < 2:
            # widen the horizon, and drop route pruning on the last try in
            # case feasibility needs a detour the shortest-path set lacks
            p = timeslot.rehorizon(
                p, 2 * p.n_slots,
                path_slack=p.path_slack if tries == 0 else None)
            r = solver.solve_fast(p, internal_obj, iters=spec.iters,
                                  tol=spec.tol, backend=spec.backend,
                                  shards=spec.mesh,
                                  precision=spec.precision,
                                  device=spec.device)
            tries += 1
        probs[i], results[i] = p, r


def _solve_group(probs, internal_obj: str, spec: SweepSpec):
    """Batched healthy solve + retry ladder; returns amortized wall time."""
    t0 = time.perf_counter()
    results = solver.solve_fast_batch(probs, internal_obj, iters=spec.iters,
                                      tol=spec.tol, backend=spec.backend,
                                      shards=spec.mesh,
                                      precision=spec.precision,
                                      device=spec.device)
    _retry_unfinished(probs, results, internal_obj, spec)
    return results, (time.perf_counter() - t0) / max(len(probs), 1)


def _solve_failure_group(healthy_probs, healthy_results, fail_name: str,
                         internal_obj: str, spec: SweepSpec):
    """Degrade every healthy instance under one failure preset and re-solve
    the whole ensemble in a single warm-started stacked dispatch."""
    t0 = time.perf_counter()
    probs = [failures.degrade_problem(
                 p, failures.sample(p.topo, fail_name, int(seed)))
             for seed, p in zip(spec.seeds, healthy_probs)]
    results = solver.solve_fast_ensemble(probs, internal_obj,
                                         warm=healthy_results,
                                         iters=spec.iters, tol=spec.tol,
                                         backend=spec.backend,
                                         shards=spec.mesh,
                                         precision=spec.precision,
                                         device=spec.device)
    _retry_unfinished(probs, results, internal_obj, spec)
    return probs, results, (time.perf_counter() - t0) / max(len(probs), 1)


def _solve_policy_group(probs, pol_name: str, internal_obj: str,
                        spec: SweepSpec):
    """Per-instance baseline-policy solves with the same horizon-doubling
    retry ladder as the LP path.  Heuristic policies are pure numpy and
    orders of magnitude cheaper than a PDHG solve, so no batching is
    needed; every returned schedule carries a core.verify certificate
    (attached by Policy.solve) and is asserted feasible-and-complete or
    retried."""
    pol = policy_zoo.get(pol_name)
    out_p, out_r = [], []
    for p in probs:
        r = pol.solve(p, internal_obj, iters=spec.iters, tol=spec.tol,
                      backend=spec.backend, device=spec.device)
        tries = 0
        while ((r.remaining_gbits > 1e-6 or not r.metrics.feasible)
               and tries < 2):
            p = timeslot.rehorizon(
                p, 2 * p.n_slots,
                path_slack=p.path_slack if tries == 0 else None)
            r = pol.solve(p, internal_obj, iters=spec.iters, tol=spec.tol,
                          backend=spec.backend, device=spec.device)
            tries += 1
        out_p.append(p)
        out_r.append(r)
    return out_p, out_r


def _policy_records(records, problems, spec: SweepSpec, say,
                    topo_name, obj, pat_name, lp_probs, lp_results,
                    offered, *, failure: str = "none",
                    ratios=None) -> None:
    """Run every spec.policies baseline over one solved cell (healthy or
    failure) and append its gap rows.

    The recorded lp rows come from the standard-budget batched solve,
    which on hard cells (min-time + packed placement) can stop a few
    percent above the LP optimum — and an unconverged PDHG
    `lp_lower_bound` is an estimate that may sit ABOVE the optimum, so
    it cannot rescue the denominator.  A baseline that "beats" such a
    reference would record a meaningless sub-1.0 gap; instead the
    reference instance is re-solved once at a much higher budget
    (solve_fast's restart ladder, shared across all policies in the
    cell) and the gap recomputed.  A gap still below 1.0 after
    tightening passes through loudly."""
    tight: dict[int, object] = {}
    for pol_name in spec.policies:
        t0 = time.perf_counter()
        p_probs, p_results = _solve_policy_group(
            list(lp_probs), pol_name, OBJECTIVES[obj], spec)
        pol_s = (time.perf_counter() - t0) / max(len(lp_probs), 1)
        gaps = []
        for i, (seed, lp_p, lp_r, pp, pr, off) in enumerate(zip(
                spec.seeds, lp_probs, lp_results, p_probs, p_results,
                offered)):
            gap = policy_zoo.gap_vs_lp(OBJECTIVES[obj], pp, pr.schedule,
                                       lp_p, tight.get(i, lp_r))
            if gap < 1.0 and i not in tight:
                tight[i] = solver.solve_fast(
                    lp_p, OBJECTIVES[obj], tol=spec.tol,
                    iters=max(8 * spec.iters, 24000), backend=spec.backend,
                    device=spec.device)
                gap = policy_zoo.gap_vs_lp(OBJECTIVES[obj], pp,
                                           pr.schedule, lp_p, tight[i])
            gaps.append(gap)
            records.append(_record(
                topo_name, obj, pat_name, seed, pp, pr, pol_s,
                offered=off, failure=failure,
                degradation_ratio=ratios[i] if ratios else 0.0,
                policy=pol_name, gap_vs_lp=gap, backend=spec.backend))
            problems.append(pp)
        tag = f"+{failure}" if failure != "none" else ""
        say(f"{topo_name:10s} {pat_name:8s} min-{obj:10s} "
            f"@{pol_name + tag:14s} "
            f"gap={np.mean(gaps):6.3f}x  ({pol_s*1e3:.1f} ms/inst)")


def _placement_records(records, problems, spec: SweepSpec, say,
                       topo_name: str, topo, obj: str,
                       method: str) -> None:
    """One placement-search cell: per seed, jointly optimize placement +
    routing (repro_torch.search.optimize_placement, one stacked batched
    dispatch per generation) and append the optimized row plus the three
    fixed-placement baseline rows it was measured against.

    The search runs once per topology x objective x seed — the sweep's
    pattern axis IS the placement being optimized, so search cells hang
    off the topology, not off any one pattern; skew/scale come from the
    spec's shared knobs."""
    pat = traffic.pattern("uniform", n_map=spec.n_map,
                          n_reduce=spec.n_reduce,
                          total_gbits=spec.total_gbits)
    cfg = search.SearchConfig(
        generations=spec.placement_generations,
        population=spec.placement_population,
        iters=spec.iters, tol=spec.tol, backend=spec.backend,
        device=spec.device, rho=spec.rho, path_slack=spec.path_slack,
        n_slots=spec.n_slots)
    if not spec.seeds:
        return
    gains, walls = [], []
    for seed in spec.seeds:
        t0 = time.perf_counter()
        res = search.optimize_placement(
            topo, pat, OBJECTIVES[obj], method=method,
            cfg=dataclasses.replace(cfg, seed=int(seed)))
        wall = time.perf_counter() - t0
        base_score = res.baselines[res.baseline_best].score
        for pat_label, cand, gain in (
                [("optimized", res.best, res.gain)]
                + [(kind, c, (base_score / c.score if c.score > 0
                              and np.isfinite(c.score) else 0.0))
                   for kind, c in res.baselines.items()]):
            rec = _record(topo_name, obj, pat_label, seed, cand.problem,
                          cand.result, wall,
                          offered=cand.problem.coflow.total_gbits,
                          backend=spec.backend)
            rec.placement_search = method
            rec.placement_gain = float(gain)
            records.append(rec)
            problems.append(cand.problem)
        gains.append(res.gain)
        walls.append(wall)
    say(f"{topo_name:10s} searched min-{obj:10s} @{method:14s} "
        f"gain={np.mean(gains):6.3f}x "
        f"(best {np.max(gains):.3f}x, {np.mean(walls):.1f} s/seed, "
        f"{res.evaluations} evals/{res.dispatches} dispatches each)")


def _solve_arrival_cell(topo, pat, fam: str, internal_obj: str,
                        spec: SweepSpec, seed: int):
    """One rolling-horizon run: a deterministic arrival trace for `seed`
    re-planned per epoch with warm-started re-solves (core.arrivals)."""
    aspec = arrivals.ArrivalSpec(family=fam,
                                 n_coflows=spec.arrival_coflows,
                                 mean_interarrival_s=spec.arrival_mean_s)
    trace = arrivals.generate_trace(topo, pat, aspec, int(seed))
    t0 = time.perf_counter()
    res = arrivals.run_online(topo, trace, internal_obj,
                              epoch_s=spec.epoch_s, rho=spec.rho,
                              path_slack=spec.path_slack, iters=spec.iters,
                              tol=spec.tol, backend=spec.backend,
                              device=spec.device)
    return trace, res, time.perf_counter() - t0


def _arrival_record(topo_name, obj, pat_name, seed, fam: str,
                    trace: list, res, wall_s: float,
                    backend: str) -> SweepRecord:
    """One SweepRecord summarizing a whole rolling-horizon trace.  The
    E/M columns hold the trace totals (executed-prefix energy summed
    over epochs, last co-flow completion); per-epoch LP provenance
    collapses to the worst epoch; lp_lower_bound is not meaningful
    across epochs and is recorded as 0."""
    offered = float(sum(a.coflow.total_gbits for a in trace))
    return SweepRecord(
        topo=topo_name, objective=obj, pattern=pat_name, seed=int(seed),
        n_flows=int(sum(a.coflow.n_flows for a in trace)),
        total_gbits=offered,
        n_slots=max((e.n_slots for e in res.epochs), default=0),
        energy_j=res.total_energy_j, completion_s=res.makespan_s,
        feasible=all(e.feasible for e in res.epochs),
        max_violation=max((e.max_violation for e in res.epochs),
                          default=0.0),
        lp_lower_bound=0.0,
        lp_primal_residual=max((e.lp_primal_residual for e in res.epochs),
                               default=0.0),
        remaining_gbits=res.backlog_gbits,
        solve_s=wall_s / max(res.n_epochs, 1), backend=backend,
        survivability=(offered - res.backlog_gbits) / max(offered, 1e-12),
        arrivals=fam, epochs=res.n_epochs,
        # NaN (no co-flow finished) passes through: a 0.0 here would
        # make the worst possible run read as instant completion
        mean_response_s=res.mean_response_s,
        backlog_gbits=res.backlog_gbits,
        warm_iterations=res.warm_iterations)


def _solve_chaos_cell(topo, pat, preset: str, internal_obj: str,
                      spec: SweepSpec, seed: int):
    """One chaos-replay cell: a deterministic poisson arrival trace run
    through the rolling-horizon driver while a seeded failure/repair
    event trace (core.chaos) degrades and repairs the fabric at epoch
    boundaries.  The hardened retry ladder ends in the certified "scf"
    fallback tier; unroutable demand parks as deferred-by-failure."""
    aspec = arrivals.ArrivalSpec(family="poisson",
                                 n_coflows=spec.arrival_coflows,
                                 mean_interarrival_s=spec.arrival_mean_s)
    trace = arrivals.generate_trace(topo, pat, aspec, int(seed))
    events = chaosmod.generate_preset_events(topo, (preset,), int(seed))
    t0 = time.perf_counter()
    res = arrivals.run_online(topo, trace, internal_obj,
                              epoch_s=spec.epoch_s, rho=spec.rho,
                              path_slack=spec.path_slack, iters=spec.iters,
                              tol=spec.tol, backend=spec.backend,
                              device=spec.device, chaos=events,
                              fallback_policy="scf")
    return trace, res, time.perf_counter() - t0


def _chaos_record(topo_name, obj, pat_name, seed, preset: str,
                  trace: list, res, wall_s: float,
                  backend: str) -> SweepRecord:
    """One SweepRecord summarizing a chaos replay (an arrival row plus
    the robustness columns)."""
    rec = _arrival_record(topo_name, obj, pat_name, seed, "poisson",
                          trace, res, wall_s, backend)
    rec.chaos = preset
    rec.availability = res.availability
    rec.stranded_gbits = res.stranded_gbits
    rec.deferred_gbits = res.deferred_failure_gbits
    rec.recover_s = (float(np.mean(res.recoveries)) if res.recoveries
                     else float("nan"))
    # backlog excludes deferred-by-failure demand (it was never
    # routable); survivability measures what the fabric allowed
    offered = float(sum(a.coflow.total_gbits for a in trace))
    rec.survivability = ((offered - res.backlog_gbits
                          - res.deferred_failure_gbits)
                         / max(offered, 1e-12))
    return rec


def _record(topo_name, obj, pat_name, seed, p, r, per_inst_s, *,
            offered: float, failure: str = "none",
            degradation_ratio: float = 0.0, policy: str = "lp",
            gap_vs_lp: float = 1.0, backend: str = "xla") -> SweepRecord:
    """One SweepRecord from a solved instance.  `offered` is the healthy
    demand in Gbits (a degraded instance's own coflow excludes flows the
    failure disconnected, but survivability is measured against what the
    job wanted to ship)."""
    m = r.metrics
    return SweepRecord(
        topo=topo_name, objective=obj, pattern=pat_name,
        seed=int(seed), n_flows=p.coflow.n_flows,
        total_gbits=p.coflow.total_gbits, n_slots=p.n_slots,
        energy_j=m.energy_j, completion_s=m.completion_s,
        feasible=bool(m.feasible), max_violation=m.max_violation,
        lp_lower_bound=r.lp_lower_bound,
        lp_primal_residual=r.lp_primal_residual,
        remaining_gbits=r.remaining_gbits, solve_s=per_inst_s,
        failure=failure, degradation_ratio=degradation_ratio,
        survivability=float(m.served.sum()) / max(offered, 1e-12),
        backend=backend, policy=policy, gap_vs_lp=gap_vs_lp)


def run_sweep(spec: SweepSpec, *, log: Callable[[str], None] | None = None
              ) -> tuple[list[SweepRecord], list[timeslot.ScheduleProblem]]:
    """Run the grid; returns (records, problems) with parallel indexing."""
    spec.validate()
    say = log or (lambda s: None)
    records: list[SweepRecord] = []
    problems: list[timeslot.ScheduleProblem] = []
    for topo_name in spec.topos:
        topo = topology.build(topo_name)
        # one placeholder per topology for arrival rows (keeps records/
        # problems index-aligned, nothing ever reads it)
        placeholder = (timeslot.ScheduleProblem(
            topo, traffic.empty_coflow(topo.n_vertices), n_slots=2,
            rho=spec.rho) if (spec.arrivals or spec.chaos) else None)
        for pat_name in spec.patterns:
            pat = traffic.pattern(pat_name, n_map=spec.n_map,
                                  n_reduce=spec.n_reduce,
                                  total_gbits=spec.total_gbits)
            t_gen = time.perf_counter()
            base_probs = _problems_for(topo, pat, spec)
            t_gen = time.perf_counter() - t_gen
            if spec.profile:
                say(f"    profile {topo_name}/{pat_name}: "
                    f"problem generation {t_gen * 1e3:.1f} ms "
                    f"({len(base_probs)} instances)")
            for obj in spec.objectives:
                # shallow copy: problems are objective-independent, but
                # _solve_group may swap entries during its retry ladder
                probs = list(base_probs)
                snap = solver.build_cache_stats().snapshot()
                t_cell = time.perf_counter()
                results, per_inst_s = _solve_group(probs, OBJECTIVES[obj], spec)
                t_cell = time.perf_counter() - t_cell
                offered = [bp.coflow.total_gbits for bp in probs]
                for seed, p, r, off in zip(spec.seeds, probs, results,
                                           offered):
                    records.append(_record(topo_name, obj, pat_name, seed,
                                           p, r, per_inst_s, offered=off,
                                           backend=spec.backend))
                    problems.append(p)
                say(f"{topo_name:10s} {pat_name:8s} min-{obj:10s} "
                    f"{len(probs)} seeds  "
                    f"E={np.mean([x.metrics.energy_j for x in results]):9.1f} J  "
                    f"M={np.mean([x.metrics.completion_s for x in results]):6.3f} s  "
                    f"({per_inst_s*1e3:.0f} ms/inst)")
                if spec.profile:
                    _profile_line(say, f"{topo_name}/{pat_name}/min-{obj}",
                                  snap, t_cell)
                _policy_records(records, problems, spec, say, topo_name,
                                obj, pat_name, probs, results, offered)
                for fail_name in spec.failures:
                    snap = solver.build_cache_stats().snapshot()
                    t_cell = time.perf_counter()
                    f_probs, f_results, f_s = _solve_failure_group(
                        probs, results, fail_name, OBJECTIVES[obj], spec)
                    t_cell = time.perf_counter() - t_cell
                    ratios, survs = [], []
                    for seed, hp, off, fp, fr in zip(
                            spec.seeds, probs, offered, f_probs, f_results):
                        ratio = failures.degradation_ratio(hp.topo, fp.topo)
                        rec = _record(topo_name, obj, pat_name, seed, fp, fr,
                                      f_s, offered=off, failure=fail_name,
                                      degradation_ratio=ratio,
                                      backend=spec.backend)
                        ratios.append(ratio)
                        survs.append(rec.survivability)
                        records.append(rec)
                        problems.append(fp)
                    say(f"{topo_name:10s} {pat_name:8s} min-{obj:10s} "
                        f"+{fail_name:9s} "
                        f"cap-{np.mean(ratios):5.1%}  "
                        f"surv={np.mean(survs):6.1%}  "
                        f"({f_s*1e3:.0f} ms/inst warm)")
                    if spec.profile:
                        _profile_line(
                            say, f"{topo_name}/{pat_name}/min-{obj}"
                                 f"+{fail_name}", snap, t_cell)
                    _policy_records(records, problems, spec, say,
                                    topo_name, obj, pat_name, f_probs,
                                    f_results, offered,
                                    failure=fail_name, ratios=ratios)
                for fam in spec.arrivals:
                    fam_recs = []
                    snap = solver.build_cache_stats().snapshot()
                    t_cell = time.perf_counter()
                    for seed in spec.seeds:
                        trace, res, wall = _solve_arrival_cell(
                            topo, pat, fam, OBJECTIVES[obj], spec, seed)
                        rec = _arrival_record(topo_name, obj, pat_name,
                                              seed, fam, trace, res, wall,
                                              spec.backend)
                        fam_recs.append(rec)
                        records.append(rec)
                        # _spot_check skips arrival rows, so nothing
                        # ever reads the placeholder
                        problems.append(placeholder)
                    say(f"{topo_name:10s} {pat_name:8s} min-{obj:10s} "
                        f"~{fam:9s} "
                        f"epochs={np.mean([r.epochs for r in fam_recs]):4.1f}  "
                        f"resp={np.mean([r.mean_response_s for r in fam_recs]):6.2f} s  "
                        f"backlog={np.mean([r.backlog_gbits for r in fam_recs]):5.2f} Gbit")
                    if spec.profile:
                        _profile_line(
                            say, f"{topo_name}/{pat_name}/min-{obj}~{fam}",
                            snap, time.perf_counter() - t_cell)
                for preset in spec.chaos:
                    cz_recs = []
                    snap = solver.build_cache_stats().snapshot()
                    t_cell = time.perf_counter()
                    for seed in spec.seeds:
                        trace, res, wall = _solve_chaos_cell(
                            topo, pat, preset, OBJECTIVES[obj], spec, seed)
                        rec = _chaos_record(topo_name, obj, pat_name,
                                            seed, preset, trace, res, wall,
                                            spec.backend)
                        cz_recs.append(rec)
                        records.append(rec)
                        problems.append(placeholder)
                    recov = [r.recover_s for r in cz_recs
                             if np.isfinite(r.recover_s)]
                    say(f"{topo_name:10s} {pat_name:8s} min-{obj:10s} "
                        f"!{preset:9s} "
                        f"avail={np.mean([r.availability for r in cz_recs]):6.1%}  "
                        f"strand={np.mean([r.stranded_gbits for r in cz_recs]):5.2f} Gbit  "
                        f"ttr={np.mean(recov) if recov else float('nan'):5.2f} s")
                    if spec.profile:
                        _profile_line(
                            say, f"{topo_name}/{pat_name}/min-{obj}"
                                 f"!{preset}", snap,
                            time.perf_counter() - t_cell)
        # placement-search cells hang off topology x objective (the
        # pattern axis is exactly what the search optimizes over)
        for obj in spec.objectives:
            for method in spec.placement_search:
                _placement_records(records, problems, spec, say,
                                   topo_name, topo, obj, method)
    if spec.oracle_check:
        _spot_check(records, problems, spec, say)
    return records, problems


def _spot_check(records, problems, spec: SweepSpec, say) -> None:
    """Re-solve the cheapest `oracle_check` instances with the exact MILP
    and record the fast path's optimality gap on the primary metric."""
    # arrival rows aggregate many epoch problems — there is no single
    # instance the MILP could certify, so they are never spot-checked;
    # policy rows are heuristics, not the fast path, so the optimality
    # spot-check skips them too (their gap column is gap_vs_lp), and so
    # are the placement search's rows
    order = sorted(
        (i for i in range(len(records))
         if records[i].arrivals == "none" and records[i].policy == "lp"
         and records[i].placement_search == "none"),
        key=lambda i: (problems[i].coflow.n_flows
                       * problems[i].topo.n_edges
                       * problems[i].topo.n_wavelengths
                       * problems[i].n_slots,
                       records[i].topo, records[i].objective,
                       records[i].pattern, records[i].seed))
    for i in order[:spec.oracle_check]:
        rec, p = records[i], problems[i]
        # the exact reference gets the paper's full route space, not the
        # fast path's pruned one
        p_full = (p if p.path_slack is None else
                  timeslot.ScheduleProblem(p.topo, p.coflow,
                                           n_slots=p.n_slots, rho=p.rho))
        res = oracle.solve(p_full, OBJECTIVES[rec.objective],
                           time_limit=spec.oracle_time_limit,
                           mip_rel_gap=1e-4)
        rec.oracle_energy_j = res.metrics.energy_j
        rec.oracle_completion_s = res.metrics.completion_s
        rec.oracle_mip_gap = res.mip_gap
        exact = (res.metrics.energy_j if rec.objective == "energy"
                 else res.metrics.completion_s)
        rec.oracle_gap = (rec.primary - exact) / max(exact, 1e-9)
        say(f"oracle spot-check {rec.topo}/{rec.pattern}/min-{rec.objective}"
            f"/seed{rec.seed}: fast={rec.primary:.4g} exact={exact:.4g} "
            f"gap={rec.oracle_gap:+.2%} (mip_gap={res.mip_gap:.2g})")
