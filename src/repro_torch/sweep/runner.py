"""Sweep driver: topology x objective x pattern x seeds, on the card.

The port of the reference's repro.sweep.runner healthy grid.  Per
(topology, pattern): one `generate_batch` builds the seed vector of
co-flow sets; per objective the whole vector solves in a few stacked
adaptive PDHG dispatches (core.solver.solve_fast_batch, every burst the
CUDA kernel on device="cuda").  Metrics are always the exact paper-model
numbers from core.timeslot.evaluate — never LP estimates.  A
deterministic subsample (the cheapest instances first) can be re-solved
with the core.oracle MILP, recording the optimality gap of the fast path
against the exact branch-and-cut schedule.

Records keep every column of the reference's SweepRecord.  `backend`
reads "pallas": the port reproduces the reference's blocked-ELL
lowering, so its rows line up with the reference's `--backend pallas`
rows.  The reference's other axes (failures, policies, placement
search, arrivals, chaos, mesh > 1) are not ported yet; SweepSpec.validate
rejects them naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from ..core import oracle, solver, timeslot, topology, traffic

# user-facing objective name -> core.solver/oracle internal name
OBJECTIVES = {"energy": "energy", "completion": "time"}

ALL_TOPOS = tuple(topology.BUILDERS)

# the one PDHG lowering the port has (the reference's blocked-ELL one)
BACKEND = "pallas"

# sweep axes of the reference that the port does not run yet, and where
# ROADMAP.md queues them
UNPORTED = {
    "failures": "queue 1 item 6: warm starts and failures",
    "arrivals": "queue 1 item 7: online arrivals and chaos",
    "chaos": "queue 1 item 7: online arrivals and chaos",
    "policies": "queue 1 item 8: policies and placement search",
    "placement_search": "queue 1 item 8: policies and placement search",
}


@dataclasses.dataclass
class SweepSpec:
    topos: tuple[str, ...] = ALL_TOPOS
    objectives: tuple[str, ...] = ("energy", "completion")
    patterns: tuple[str, ...] = ("uniform", "skew", "packed")
    seeds: tuple[int, ...] = tuple(range(8))
    # the reference's further axes; the port rejects anything but empty
    # (see UNPORTED)
    failures: tuple[str, ...] = ()
    policies: tuple[str, ...] = ()
    placement_search: tuple[str, ...] = ()
    arrivals: tuple[str, ...] = ()
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
    # scale knobs: precision="bf16" stores the PDHG iterates in bfloat16
    # between iterations (fp32 arithmetic); mesh > 1 (row-sharded PDHG)
    # is not ported yet
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
        for axis, item in UNPORTED.items():
            if getattr(self, axis):
                raise ValueError(f"the {axis} axis is not ported yet "
                                 f"(ROADMAP {item})")
        if self.mesh > 1:
            raise ValueError("mesh > 1 (row-sharded PDHG) is not ported yet "
                             "(ROADMAP queue 1 item 10)")
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
        solver._check_scale_opts(self.mesh, self.precision)


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
    backend: str = BACKEND            # PDHG lowering that produced this row
    # online-arrival rows; arrivals == "none" marks an offline row
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
    # baseline policy name (not ported yet)
    policy: str = "lp"
    gap_vs_lp: float = 1.0
    # placement-search rows: "none" marks ordinary rows
    placement_search: str = "none"
    placement_gain: float = 1.0
    # chaos-replay rows: "none" marks a healthy row
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
                                  tol=spec.tol, shards=spec.mesh,
                                  precision=spec.precision,
                                  device=spec.device)
            tries += 1
        probs[i], results[i] = p, r


def _solve_group(probs, internal_obj: str, spec: SweepSpec):
    """Batched healthy solve + retry ladder; returns amortized wall time."""
    t0 = time.perf_counter()
    results = solver.solve_fast_batch(probs, internal_obj, iters=spec.iters,
                                      tol=spec.tol, shards=spec.mesh,
                                      precision=spec.precision,
                                      device=spec.device)
    _retry_unfinished(probs, results, internal_obj, spec)
    return results, (time.perf_counter() - t0) / max(len(probs), 1)


def _record(topo_name, obj, pat_name, seed, p, r, per_inst_s, *,
            offered: float) -> SweepRecord:
    """One SweepRecord from a solved instance.  `offered` is the demand
    in Gbits that survivability is measured against."""
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
        survivability=float(m.served.sum()) / max(offered, 1e-12))


def run_sweep(spec: SweepSpec, *, log: Callable[[str], None] | None = None
              ) -> tuple[list[SweepRecord], list[timeslot.ScheduleProblem]]:
    """Run the grid; returns (records, problems) with parallel indexing."""
    spec.validate()
    say = log or (lambda s: None)
    records: list[SweepRecord] = []
    problems: list[timeslot.ScheduleProblem] = []
    for topo_name in spec.topos:
        topo = topology.build(topo_name)
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
                                           p, r, per_inst_s, offered=off))
                    problems.append(p)
                say(f"{topo_name:10s} {pat_name:8s} min-{obj:10s} "
                    f"{len(probs)} seeds  "
                    f"E={np.mean([x.metrics.energy_j for x in results]):9.1f} J  "
                    f"M={np.mean([x.metrics.completion_s for x in results]):6.3f} s  "
                    f"({per_inst_s*1e3:.0f} ms/inst)")
                if spec.profile:
                    _profile_line(say, f"{topo_name}/{pat_name}/min-{obj}",
                                  snap, t_cell)
    if spec.oracle_check:
        _spot_check(records, problems, spec, say)
    return records, problems


def _spot_check(records, problems, spec: SweepSpec, say) -> None:
    """Re-solve the cheapest `oracle_check` instances with the exact MILP
    and record the fast path's optimality gap on the primary metric."""
    order = sorted(
        range(len(records)),
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
