"""Joint placement + routing: placement search over a batched LP evaluator.

The paper fixes task placement (spread/packed/local) and lets the LP
only route; its lineage (arXiv 1904.03298, VM embedding for PON DCNs)
optimizes both.  This module closes that gap with two derivative-free
optimizers over `core.traffic.Placement` values — simulated annealing
(parallel Metropolis chains) and a small genetic algorithm — using the
routing LP fast path as the inner evaluator.

Batching is the throughput lever: a placement changes flow endpoints,
so per-candidate structure-cache hits are impossible (the cache keys on
flow/edge incidence).  Instead, every generation's candidate population
is evaluated in ONE stacked `core.solver.solve_fast_batch` dispatch
(the candidates share a topology and flow count).  The horizon is
pinned across the whole run (max of the seed generation's suggestions),
as in the reference, whose shape bucketing it serves there; here it
keeps the candidates' scores, and so the trajectory, the reference's.

Every incumbent update is certified by `core.verify.check_schedule`
before it is accepted: a candidate whose packed schedule does not carry
a zero-violation feasibility certificate scores +inf and can never win.

Scores are the exact paper-model metrics (core.timeslot.evaluate) —
energy in Joules for "energy"/"fair", completion seconds for "time" —
never LP estimates.  `SearchResult.gain` is best-fixed-baseline score
over optimized score on the same pinned map-output sizes (> 1 means the
search strictly beat spread, packed, AND local).
"""
from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np
import torch

from .. import device as _device
from ..core import solver, timeslot, traffic, verify
from ..core.topology import Topology
from ..core.traffic import Placement, TrafficPattern
from . import moves

METHODS = ("sa", "ga")
# the reference's stream tag, kept so a seed draws the same placements
SEARCH_TAG = zlib.crc32(b"repro.search")
# canonical fixed placements evaluated as the comparison baselines (and
# as the first members of the seed population)
BASELINES = ("spread", "packed", "local")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Knobs for optimize_placement (see docs/PLACEMENT.md)."""

    generations: int = 6       # move rounds after the seed generation
    population: int = 8        # candidates per stacked dispatch
    seed: int = 0
    iters: int = 1500          # PDHG iterations per evaluator dispatch
    tol: float = 2e-3
    backend: str = "xla"       # PDHG lowering (solver.BACKENDS)
    device: str | torch.device = "cuda"   # where the bursts run
    rho: float = 8.0
    path_slack: int | None = 2
    n_slots: int | None = None  # None: pin max(seed-generation suggestions)
    # SA: relative temperature ladder — accept a relative regression d
    # with prob exp(-d / (t0_frac * alpha^g))
    t0_frac: float = 0.05
    alpha: float = 0.7
    # GA: elitism + tournament-2 selection, crossover then mutation
    elite: int = 2
    mutations: int = 1

    def validate(self) -> None:
        if self.generations < 0 or self.population < 1:
            raise ValueError(f"need generations >= 0 and population >= 1, "
                             f"got {self.generations}, {self.population}")
        if self.backend not in solver.BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"have {solver.BACKENDS}")
        # ValueError for a device type other than cuda/cpu; RuntimeError
        # when cuda is asked for and no card is available
        _device.resolve(self.device)
        if not 0 < self.alpha <= 1 or self.t0_frac <= 0:
            raise ValueError("need 0 < alpha <= 1 and t0_frac > 0")
        if self.elite < 0 or self.elite >= max(self.population, 1) + 3:
            raise ValueError(f"elite {self.elite} out of range")


@dataclasses.dataclass
class Candidate:
    """One evaluated placement: problem, solved fast-path result, score."""

    placement: Placement
    problem: timeslot.ScheduleProblem
    result: solver.FastPathResult
    score: float                       # +inf when infeasible/uncertified


@dataclasses.dataclass
class SearchResult:
    method: str
    objective: str                     # solver-internal: "energy" | "time"
    topo_name: str
    best: Candidate                    # certified incumbent
    baselines: dict[str, Candidate]    # spread / packed / local
    baseline_best: str                 # name of the winning fixed placement
    gain: float                        # baseline score / best score (>= 1)
    evaluations: int                   # LP evaluations spent (all candidates)
    dispatches: int                    # stacked solver dispatches issued
    history: list[float]               # incumbent score per generation

    @property
    def improved(self) -> bool:
        """True when the search strictly beat every fixed placement."""
        return self.gain > 1.0


def _score(objective: str, r: solver.FastPathResult) -> float:
    if r.remaining_gbits > 1e-6 or not r.metrics.feasible:
        return math.inf
    return float(r.metrics.energy_j if objective != "time"
                 else r.metrics.completion_s)


def evaluate_placements(topo: Topology, pat: TrafficPattern,
                        placements: list[Placement], objective: str, *,
                        map_out: np.ndarray, n_slots: int,
                        cfg: SearchConfig) -> list[Candidate]:
    """Score a candidate population in ONE stacked batched dispatch."""
    problems = []
    for pl in placements:
        cf = traffic.generate_from_placement(topo, pat, pl, map_out=map_out)
        problems.append(timeslot.ScheduleProblem(
            topo, cf, n_slots=n_slots, rho=cfg.rho,
            path_slack=cfg.path_slack))
    results = solver.solve_fast_batch(problems, objective, iters=cfg.iters,
                                      tol=cfg.tol, backend=cfg.backend,
                                      device=cfg.device)
    return [Candidate(pl, p, r, _score(objective, r))
            for pl, p, r in zip(placements, problems, results)]


def _retry(c: Candidate, objective: str, cfg: SearchConfig) -> Candidate:
    """Horizon-doubling ladder for an unfinished candidate (same policy
    as the sweep's retry: widen twice, drop route pruning last)."""
    p, r, tries = c.problem, c.result, 0
    while (r.remaining_gbits > 1e-6 or not r.metrics.feasible) and tries < 2:
        p = timeslot.rehorizon(p, 2 * p.n_slots,
                               path_slack=p.path_slack if tries == 0
                               else None)
        r = solver.solve_fast(p, objective, iters=cfg.iters, tol=cfg.tol,
                              backend=cfg.backend, device=cfg.device)
        tries += 1
    return Candidate(c.placement, p, r, _score(objective, r))


def _certify(c: Candidate) -> bool:
    """Attach a feasibility certificate; False (and +inf score) if the
    schedule does not certify — an uncertified incumbent cannot win."""
    cert = verify.check_schedule(c.problem, c.result.schedule)
    if not cert.ok:
        c.score = math.inf
        return False
    c.result.certificate = cert
    return True


def _random_spread(topo: Topology, pat: TrafficPattern,
                   rng: np.random.Generator) -> Placement:
    return traffic.sample_placement(
        topo, dataclasses.replace(pat, placement="spread"), rng)


def _seed_population(topo: Topology, pat: TrafficPattern,
                     rng: np.random.Generator, cfg: SearchConfig
                     ) -> tuple[list[str], list[Placement]]:
    """Canonical spread/packed/local first, random spreads to fill."""
    names, pls = [], []
    for kind in BASELINES:
        names.append(kind)
        pls.append(traffic.sample_placement(
            topo, dataclasses.replace(pat, placement=kind), rng))
    while len(pls) < max(cfg.population, len(BASELINES)):
        names.append(f"rand{len(pls) - len(BASELINES)}")
        pls.append(_random_spread(topo, pat, rng))
    return names, pls


def optimize_placement(topo: Topology, pat: TrafficPattern,
                       objective: str = "energy", *,
                       method: str = "sa",
                       cfg: SearchConfig | None = None,
                       **overrides) -> SearchResult:
    """Optimize the task placement of one shuffle co-flow.

    Args:
      topo/pat: the topology and traffic pattern; the pattern's own
        `placement` field is ignored (placement is what we search over),
        its skew/scale fields pin the map-output sizes for the whole
        run so candidates are comparable.
      objective: solver-internal "energy", "time", or "fair".
      method: "sa" (parallel-chain simulated annealing) or "ga".
      cfg/overrides: SearchConfig knobs (overrides win over cfg);
        `backend` is the PDHG lowering ("xla", the default as in the
        reference, or "pallas") and `device` ("cuda" by default, raising
        without a card, or "cpu") where every generation's bursts run.

    Deterministic per (seed, method): all randomness flows from
    np.random.default_rng([seed, SEARCH_TAG, method_index]) and its
    spawned per-chain children.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; have {METHODS}")
    cfg = dataclasses.replace(cfg or SearchConfig(), **overrides)
    cfg.validate()
    rng = np.random.default_rng(
        [int(cfg.seed), SEARCH_TAG, METHODS.index(method)])
    # sizes are pinned once per run from a dedicated child stream
    map_out = traffic._map_outputs(pat, rng.spawn(1)[0])

    names, pls = _seed_population(topo, pat, rng, cfg)
    n_slots = cfg.n_slots or max(
        timeslot.suggest_n_slots(
            topo, traffic.generate_from_placement(topo, pat, pl,
                                                  map_out=map_out),
            rho=cfg.rho)
        for pl in pls[:len(BASELINES)])
    seed_gen = evaluate_placements(topo, pat, pls, objective,
                                   map_out=map_out, n_slots=n_slots,
                                   cfg=cfg)
    evaluations, dispatches = len(seed_gen), 1
    # baselines must always be scored: retry unfinished canonical cells
    for i in range(len(BASELINES)):
        if not math.isfinite(seed_gen[i].score):
            seed_gen[i] = _retry(seed_gen[i], objective, cfg)
    baselines = dict(zip(BASELINES, seed_gen[:len(BASELINES)]))
    for c in baselines.values():
        _certify(c)
    finite = [c for c in seed_gen if math.isfinite(c.score)]
    if not finite:
        raise RuntimeError(
            f"{topo.name}/min-{objective}: no feasible certified seed "
            f"placement (population {len(seed_gen)}) — widen n_slots "
            f"or raise iters")
    best = min(finite, key=lambda c: c.score)
    if not _certify(best):
        finite = [c for c in finite if math.isfinite(c.score)]
        best = min(finite, key=lambda c: c.score)
        _certify(best)
    history = [best.score]

    if method == "sa":
        best = _anneal(topo, pat, objective, seed_gen, best, history, rng,
                       map_out, n_slots, cfg)
        evaluations += cfg.generations * min(cfg.population, len(seed_gen))
        dispatches += cfg.generations
    else:
        best, n_evals, n_disp = _evolve(topo, pat, objective, seed_gen,
                                        best, history, rng, map_out,
                                        n_slots, cfg)
        evaluations += n_evals
        dispatches += n_disp

    base_best = min(BASELINES, key=lambda k: baselines[k].score)
    base_score = baselines[base_best].score
    gain = (base_score / best.score if math.isfinite(base_score)
            and best.score > 0 else 1.0)
    return SearchResult(method=method, objective=objective,
                        topo_name=topo.name, best=best,
                        baselines=baselines, baseline_best=base_best,
                        gain=gain, evaluations=evaluations,
                        dispatches=dispatches, history=history)


def _anneal(topo, pat, objective, seed_gen, best, history, rng,
            map_out, n_slots, cfg: SearchConfig) -> Candidate:
    """Parallel Metropolis chains sharing one stacked dispatch per step.

    Each of the `population` chains proposes one move per generation;
    acceptance uses the RELATIVE regression d = (new - cur)/cur against
    a geometric temperature ladder t0_frac * alpha^g, so one schedule
    fits every topology's score scale (Joules vary by 50x across DCNs).
    """
    chains = list(seed_gen[:cfg.population])
    chain_rngs = rng.spawn(len(chains))
    for g in range(cfg.generations):
        temp = cfg.t0_frac * cfg.alpha ** g
        proposals = [moves.propose(c.placement, topo, cr)
                     for c, cr in zip(chains, chain_rngs)]
        cands = evaluate_placements(topo, pat, proposals, objective,
                                    map_out=map_out, n_slots=n_slots,
                                    cfg=cfg)
        for k, (cur, new, cr) in enumerate(zip(chains, cands, chain_rngs)):
            if not math.isfinite(new.score):
                continue
            d = (new.score - cur.score) / max(abs(cur.score), 1e-12)
            if d <= 0 or cr.random() < math.exp(-d / temp):
                chains[k] = new
                if new.score < best.score and _certify(new):
                    best = new
        history.append(best.score)
    return best


def _tournament(pop: list[Candidate], rng) -> Candidate:
    a, b = rng.integers(len(pop), size=2)
    return min(pop[int(a)], pop[int(b)], key=lambda c: c.score)


def _crossover(a: Placement, b: Placement, topo, rng) -> Placement:
    """Mappers from parent a, reducers from parent b; conflicts repaired
    from free servers (falls back to parent a when fully occupied)."""
    m = a.mappers.copy()
    r = b.reducers.copy()
    taken = set(m.tolist())
    free = [s for s in topo.task_servers
            if s not in taken and s not in set(r.tolist())]
    for k, s in enumerate(r.tolist()):
        if s in taken:
            if not free:
                return Placement(a.mappers.copy(), a.reducers.copy())
            s = int(free.pop(int(rng.integers(len(free)))))
            r[k] = s
        taken.add(int(r[k]))
    return Placement(m, r)


def _evolve(topo, pat, objective, seed_gen, best, history, rng,
            map_out, n_slots, cfg: SearchConfig):
    """Small steady-state GA: elitism + tournament-2 + crossover +
    move-set mutation; one stacked dispatch per generation."""
    pop = sorted(seed_gen, key=lambda c: c.score)[:cfg.population]
    n_off = max(cfg.population - cfg.elite, 1)
    evals = disp = 0
    for _ in range(cfg.generations):
        offspring = []
        for _k in range(n_off):
            pa, pb = _tournament(pop, rng), _tournament(pop, rng)
            child = _crossover(pa.placement, pb.placement, topo, rng)
            for _m in range(cfg.mutations):
                child = moves.propose(child, topo, rng)
            offspring.append(child)
        cands = evaluate_placements(topo, pat, offspring, objective,
                                    map_out=map_out, n_slots=n_slots,
                                    cfg=cfg)
        evals += len(cands)
        disp += 1
        merged = pop[:cfg.elite] + [c for c in cands
                                    if math.isfinite(c.score)]
        merged += pop[cfg.elite:]          # keep survivors competitive
        pop = sorted(merged, key=lambda c: c.score)[:cfg.population]
        if pop[0].score < best.score and _certify(pop[0]):
            best = pop[0]
        history.append(best.score)
    return best, evals, disp
