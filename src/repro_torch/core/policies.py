"""Baseline scheduler policies with a solve_fast-compatible interface.

A copy of the reference `repro.core.policies`: the heuristic policies
are numpy and bitwise the reference's (tests/test_torch_policies.py);
`fair-lp` solves through the port's `solve_fast` on the card (or, with
device="cpu", the kernel's plain version), in either PDHG lowering
(`backend=`).

The paper reports only MILP-optimal schedules; production operators ask
a different question — how much does the optimal LP routing actually
buy over the schedulers data centres run today?  This module answers it
with a policy zoo every sweep cell can run next to the LP:

  ecmp           hash-based route selection over each flow's
                 near-shortest admissible path set (what ECMP switches
                 do), volumes packed by temporal_pack's water-filling
  least-loaded   greedy per-flow routing (largest flows first) onto the
                 candidate path minimizing projected bottleneck link
                 utilization, then temporal_pack
  scf            shortest-flow-first: shortest-path routing with a
                 strict smallest-remaining-demand priority packer
                 (the co-flow literature's clairvoyant SJF baseline)
  fair           shortest-path routing packed by temporal_pack's
                 proportional water-filling — progressive filling is
                 max-min-lite fair sharing
  fair-lp        the LP fast path under the "fair" objective (energy
                 re-priced by 1 / ScheduleProblem.flow_weight): the
                 weighted max-min fairness variant, solved by PDHG
                 through the burst kernel

Every policy returns the same `FastPathResult` type as
`core.solver.solve_fast` — exact `core.timeslot.evaluate` metrics, a
`core.verify.check_schedule` certificate attached, and enough state
(`index`, `paths`, `lp_x`) to seed `project_warm_start`, so the service
loop can fall back to a policy and still warm-start the next window's
LP from it.  On a policy result `lp_lower_bound` holds `lp_cost` of its
OWN schedule (there is no LP bound to report); the optimality gap the
sweep records is computed by `gap_vs_lp`, which evaluates one shared
LP-objective functional (`lp_cost`) on both the policy's and the LP's
packed schedules — so "policy X is 1.4x worse" compares like with like
and is backed by feasibility certificates on both sides.

Flows whose demand a failure zeroed (core.failures.degrade_problem)
are skipped, exactly as the LP ships nothing for them.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from . import verify
from .solver import (FastPathResult, FlowPath, RoutingIndex, _admissible,
                     _device_cost_per_gbit, _out_edges, _route_search,
                     solve_fast, temporal_pack)
from .timeslot import ScheduleProblem, _hop_distances, evaluate

DEFAULT_K_PATHS = 4      # candidate paths per flow for ecmp/least-loaded
_GAP_NOISE = 0.02        # sub-1.0 gap ratios within this are certified ties
_ENUM_SLACK = 2          # enumerate paths <= shortest + this many hops
_ENUM_MAX = 12           # candidates collected per flow before selection
_ENUM_BUDGET = 6000      # DFS state expansions per flow (hard stop)


# ---------------------------------------------------------------------------
# Shared LP-objective functional (gap numerators and denominators)
# ---------------------------------------------------------------------------

def lp_cost(p: ScheduleProblem, objective: str, x: np.ndarray) -> float:
    """Evaluate the routing LP's objective on a packed schedule tensor.

    Aggregates x over slots into per-(flow, edge, wavelength) volumes
    and applies exactly the cost the LP minimizes (core.solver._fill_lp):

      energy   c_e = (eps_u + eps_v) + (contrib_u + contrib_v) + 1e-6
               summed over shipped Gbits;
      fair     the energy cost with each flow's Gbits divided by its
               flow_weight (uniform weights reduce to energy);
      time     theta(x) — the smallest continuous-time horizon scale
               making the aggregate volumes rate-feasible: max over the
               LP's coupled rows of usage / limit (link capacity,
               server egress rho, switch ingress sigma).  Horizon-
               independent, so schedules packed under different
               rehorizoned slot counts compare cleanly.

    This single functional scores both sides of every gap the sweep
    reports (`gap_vs_lp`)."""
    assert objective in ("energy", "time", "fair"), objective
    vol = np.asarray(x).sum(axis=3)                     # (F, E, W)
    if objective == "time":
        psi = vol.sum(axis=0)                           # (E, W)
        cap = p.topo.cap
        pos = cap > 0.0
        theta = float((psi[pos] / cap[pos]).max(initial=0.0)) \
            if pos.any() else 0.0
        flat = psi.sum(axis=1)                          # (E,)
        egress = np.zeros(p.topo.n_vertices)
        np.add.at(egress, p.e_src, flat)
        if np.isfinite(p.rho):
            theta = max(theta, float(
                (egress[p.is_server] / p.rho).max(initial=0.0)))
        ingress = np.zeros(p.topo.n_vertices)
        np.add.at(ingress, p.e_dst, flat)
        sw = p.is_switch & np.isfinite(p.sigma)
        if sw.any():
            theta = max(theta, float(
                (ingress[sw] / p.sigma[sw]).max(initial=0.0)))
        return theta
    contrib = _device_cost_per_gbit(p)
    u, v = p.e_src, p.e_dst
    eps_u = np.where(p.is_server[u], p.eps[u], 0.0)
    eps_v = np.where(p.is_server[v], p.eps[v], 0.0)
    c_e = (eps_u + eps_v) + (contrib[u] + contrib[v]) + 1e-6    # (E,)
    vol_fe = vol.sum(axis=2)                            # (F, E)
    if objective == "fair" and p.flow_weight is not None:
        vol_fe = vol_fe / p.flow_weight[:, None]
    return float((vol_fe * c_e[None, :]).sum())


def gap_vs_lp(objective: str, p_pol: ScheduleProblem, x_pol: np.ndarray,
              p_lp: ScheduleProblem, lp_result: FastPathResult) -> float:
    """Policy-vs-LP optimality ratio under the shared `lp_cost`
    functional; >= 1.0 means the policy is that factor worse.

    The denominator is min(packed-LP cost, PDHG's own LP bound): the
    packed LP schedule rescales volumes to exact demand, which can lift
    its cost epsilon above the LP optimum, while the PDHG bound can sit
    epsilon below it — taking the min keeps the reference on the
    optimistic side.  The exact LP relaxation lower-bounds EVERY
    feasible schedule, so a ratio below 1.0 can only be PDHG
    convergence noise; ratios within `_GAP_NOISE` of 1.0 are reported
    as exactly 1.0 (a certified tie), while anything lower passes
    through — a sub-0.98 "win" over the LP means the reference or the
    functional is broken and the tests should see it."""
    num = lp_cost(p_pol, objective, x_pol)
    den = lp_cost(p_lp, objective, lp_result.schedule)
    if np.isfinite(lp_result.lp_lower_bound) and lp_result.lp_lower_bound > 0:
        den = min(den, float(lp_result.lp_lower_bound))
    if den <= 1e-12:
        return 1.0
    ratio = num / den
    if 1.0 - _GAP_NOISE <= ratio < 1.0:
        return 1.0
    return ratio


# ---------------------------------------------------------------------------
# Candidate near-shortest path sets
# ---------------------------------------------------------------------------

def path_sets(p: ScheduleProblem, k: int = DEFAULT_K_PATHS
              ) -> tuple[RoutingIndex, list[list[FlowPath]]]:
    """Per flow: up to `k` near-shortest admissible paths (hop count
    within `_ENUM_SLACK` of shortest), honouring the same wavelength-
    continuity rules as the LP's route space (conversion only at
    electronic vertices).  Deterministic: DFS enumeration in fixed
    edge/wavelength order, candidates sorted by (length, hop tuple),
    selection prefers distinct first hops so ECMP has real spreading to
    hash over.  Flows with zero demand (failure-disconnected) get empty
    sets.  Memoized on the ScheduleProblem instance."""
    cached = getattr(p, "_path_sets_cache", None)
    if cached is not None and cached[0] == k:
        return cached[1], cached[2]
    kf, ke, kw = _admissible(p)
    idx = RoutingIndex(kf, ke, kw,
                       p.coflow.n_flows * p.topo.n_wavelengths, 0)
    F, E, W, _ = p.shape_x
    passive = ~(p.is_server | p.is_switch)
    out_edges = _out_edges(p)
    dist = _hop_distances(p.topo)
    e_dst = p.e_dst
    bounds = np.searchsorted(kf, np.arange(F + 1))
    k_map = np.full((E, W), -1, dtype=np.int64)

    sets: list[list[FlowPath]] = []
    for f in range(F):
        lo, hi = bounds[f], bounds[f + 1]
        size = float(p.coflow.size[f])
        if size <= 0.0 or lo == hi:
            sets.append([])
            continue
        es, ws = ke[lo:hi], kw[lo:hi]
        k_map[es, ws] = np.arange(lo, hi)
        src, dst = int(p.coflow.src[f]), int(p.coflow.dst[f])
        d0 = dist[src, dst]
        bound = (int(d0) if np.isfinite(d0) else E) + _ENUM_SLACK

        found: list[tuple[tuple[int, int], ...]] = []
        budget = _ENUM_BUDGET

        def dfs(u, w_in, trail, visited):
            nonlocal budget
            if len(found) >= _ENUM_MAX or budget <= 0:
                return
            budget -= 1
            if u == dst:
                found.append(tuple(trail))
                return
            if len(trail) >= bound:
                return
            convert = (w_in == -1) or not passive[u]
            for e in out_edges[u]:
                v = int(e_dst[e])
                if v in visited or len(trail) + 1 + dist[v, dst] > bound:
                    continue
                for w in range(W):
                    if not convert and w != w_in:
                        continue
                    if k_map[e, w] < 0:
                        continue
                    visited.add(v)
                    trail.append((e, w))
                    dfs(v, w, trail, visited)
                    trail.pop()
                    visited.discard(v)

        dfs(src, -1, [], {src})
        if not found:
            # budget exhausted before any hit (dist ignores wavelength
            # continuity, so pruning can leave only dead ends): fall
            # back to the unbounded admissibility DFS the LP itself uses
            trail = _route_search(p, out_edges, src, dst,
                                  lambda e, w: k_map[e, w] >= 0,
                                  ~passive)
            if trail:
                found.append(tuple(trail))
        if not found:
            k_map[es, ws] = -1
            raise RuntimeError(f"flow {f}: no admissible path "
                               f"({src}->{dst})")
        found.sort(key=lambda tr: (len(tr), tr))
        chosen: list[tuple[tuple[int, int], ...]] = []
        first_hops: set[tuple[int, int]] = set()
        for tr in found:                      # one path per first hop first
            if tr[0] not in first_hops:
                chosen.append(tr)
                first_hops.add(tr[0])
            if len(chosen) >= k:
                break
        for tr in found:                      # then fill by rank
            if len(chosen) >= k:
                break
            if tr not in chosen:
                chosen.append(tr)
        flow_paths = []
        for tr in chosen:
            pe = np.array([e for e, _ in tr], dtype=np.int64)
            pw = np.array([w for _, w in tr], dtype=np.int64)
            flow_paths.append(FlowPath(f, k_map[pe, pw].copy(),
                                       size, int(pw[0])))
        sets.append(flow_paths)
        k_map[es, ws] = -1            # reset scratch for the next flow
    p._path_sets_cache = (k, idx, sets)
    return idx, sets


# ---------------------------------------------------------------------------
# FastPathResult assembly shared by all heuristic policies
# ---------------------------------------------------------------------------

def _injection_vector(p: ScheduleProblem, idx: RoutingIndex,
                      x: np.ndarray) -> np.ndarray:
    """LP-layout primal vector [triple volumes, per-(f, w) injections]
    for a packed schedule — lets project_warm_start treat a policy
    result exactly like an LP one."""
    F, E, W, _ = p.shape_x
    vol = x.sum(axis=3)                                  # (F, E, W)
    out = np.zeros(len(idx.kf) + idx.n_inj + idx.n_theta)
    out[:len(idx.kf)] = vol[idx.kf, idx.ke, idx.kw]
    for f in range(F):
        s = p.coflow.src[f]
        inj = (vol[f, p.e_src == s].sum(axis=0)
               - vol[f, p.e_dst == s].sum(axis=0))       # (W,)
        out[len(idx.kf) + f * W:len(idx.kf) + (f + 1) * W] = \
            np.maximum(inj, 0.0)
    return out


def _result(p: ScheduleProblem, objective: str, idx: RoutingIndex,
            paths: list[FlowPath], x: np.ndarray) -> FastPathResult:
    m = evaluate(p, x)
    cert = verify.check_schedule(p, x)
    return FastPathResult(
        schedule=x, metrics=m,
        lp_lower_bound=lp_cost(p, objective, x),   # own cost, not a bound
        lp_primal_residual=0.0,
        remaining_gbits=float(np.maximum(p.coflow.size - m.served,
                                         0.0).sum()),
        lp_x=_injection_vector(p, idx, x), lp_y=None,
        index=idx, paths=paths, iterations=0, certificate=cert)


def _strict_priority_pack(p: ScheduleProblem, idx: RoutingIndex,
                          paths: list[FlowPath]) -> np.ndarray:
    """Slot-by-slot packing serving flows in strict ascending remaining-
    demand order (shortest-flow-first) — each flow grabs as much of its
    path's slack as the caps allow before the next is considered.
    Honours release slots and PON3's one-TX-wavelength rule (a server
    whose slot already transmits on wavelength w only serves same-w
    paths until the next slot)."""
    F, E, W, T = p.shape_x
    D = p.topo.slot_duration
    slot_cap = p.slot_cap_gbits
    srv_lim = np.where(p.is_server, p.rho * D, np.inf)
    sw_lim = np.where(p.is_switch & np.isfinite(p.sigma),
                      p.sigma * D, np.inf)
    kf, ke, kw = idx.kf, idx.ke, idx.kw
    remaining = p.coflow.size.astype(float).copy()
    eq47 = p.topo.one_wavelength_tx and p.topo.awgr_in_ports
    awgr_in = np.isin(p.e_dst, p.topo.awgr_in_ports) if eq47 else None
    x = np.zeros((F, E, W, T))
    for t in range(T):
        if remaining.max(initial=0.0) <= 1e-9:
            break
        used_ew = np.zeros((E, W))
        egress = np.zeros(p.topo.n_vertices)
        ingress = np.zeros(p.topo.n_vertices)
        tx_w: dict[int, int] = {}        # server -> elected TX wavelength
        active = [pp for pp in paths if remaining[pp.flow] > 1e-9]
        if p.release_slot is not None:
            active = [pp for pp in active
                      if int(p.release_slot[pp.flow]) <= t]
        active.sort(key=lambda pp: (remaining[pp.flow], pp.flow))
        for pp in active:
            ks = pp.triples
            if eq47 and awgr_in[ke[ks[0]]]:
                i = int(p.e_src[ke[ks[0]]])
                if p.is_server[i]:
                    w0 = int(kw[ks[0]])
                    if tx_w.setdefault(i, w0) != w0:
                        continue      # another wavelength owns this slot
            slack = np.min(np.concatenate([
                slot_cap[ke[ks], kw[ks]] - used_ew[ke[ks], kw[ks]],
                srv_lim[p.e_src[ke[ks]]] - egress[p.e_src[ke[ks]]],
                sw_lim[p.e_dst[ke[ks]]] - ingress[p.e_dst[ke[ks]]]]))
            ship = min(float(remaining[pp.flow]), max(float(slack), 0.0))
            if ship <= 1e-9:
                continue
            np.add.at(used_ew, (ke[ks], kw[ks]), ship)
            np.add.at(egress, p.e_src[ke[ks]], ship)
            np.add.at(ingress, p.e_dst[ke[ks]], ship)
            np.add.at(x, (kf[ks], ke[ks], kw[ks], np.full(len(ks), t)),
                      ship)
            remaining[pp.flow] -= ship
    return x


# ---------------------------------------------------------------------------
# The policy family
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Policy:
    """One baseline scheduler.  `solve` mirrors solve_fast's signature;
    heuristic policies ignore iters/tol/backend/device (accepted for
    drop-in interface parity) and are pure numpy, hence backend- and
    device-independent."""

    name: str
    summary: str

    def route(self, p: ScheduleProblem, objective: str
              ) -> tuple[RoutingIndex, list[FlowPath]]:
        raise NotImplementedError

    def pack(self, p: ScheduleProblem, idx: RoutingIndex,
             paths: list[FlowPath]) -> np.ndarray:
        return temporal_pack(p, idx, np.zeros(len(idx.kf)), paths=paths)

    def solve(self, p: ScheduleProblem, objective: str = "energy", *,
              iters: int = 0, tol: float | None = None,
              backend: str = "xla",
              device: str | torch.device = "cuda") -> FastPathResult:
        idx, paths = self.route(p, objective)
        x = self.pack(p, idx, paths)
        return _result(p, objective, idx, paths, x)


@dataclasses.dataclass(frozen=True)
class EcmpPolicy(Policy):
    """Deterministic hash spreading over near-shortest path sets: each
    flow keys crc32("flow:src:dst") into its candidate list — route
    choice is independent of demands and of other flows, exactly the
    obliviousness real ECMP pays for (tests pin the invariance)."""

    def route(self, p, objective):
        idx, sets = path_sets(p)
        paths = []
        for f, cand in enumerate(sets):
            if not cand:
                continue
            key = (f"{f}:{int(p.coflow.src[f])}:"
                   f"{int(p.coflow.dst[f])}").encode()
            paths.append(cand[zlib.crc32(key) % len(cand)])
        return idx, paths


@dataclasses.dataclass(frozen=True)
class LeastLoadedPolicy(Policy):
    """Greedy load-aware routing: flows in descending size order pick
    the candidate path minimizing the projected bottleneck utilization
    (offered Gbits / capacity) over its hops — a centralized version of
    per-link least-loaded dispatch."""

    def route(self, p, objective):
        idx, sets = path_sets(p)
        ke, kw = idx.ke, idx.kw
        cap = p.topo.cap
        load = np.zeros((p.topo.n_edges, p.topo.n_wavelengths))
        order = np.argsort(-p.coflow.size, kind="stable")
        chosen = {}
        for f in order:
            cand = sets[int(f)]
            if not cand:
                continue
            size = float(p.coflow.size[f])
            best, best_key = None, None
            for j, fp in enumerate(cand):
                es, wss = ke[fp.triples], kw[fp.triples]
                util = float(((load[es, wss] + size)
                              / np.maximum(cap[es, wss], 1e-9)).max())
                key = (util, len(fp.triples), j)
                if best_key is None or key < best_key:
                    best, best_key = fp, key
            chosen[int(f)] = best
            es, wss = ke[best.triples], kw[best.triples]
            np.add.at(load, (es, wss), size)
        return idx, [chosen[f] for f in sorted(chosen)]


@dataclasses.dataclass(frozen=True)
class ShortestFirstPolicy(Policy):
    """Shortest-flow-first: shortest-path routing, strict smallest-
    remaining-demand priority packing (clairvoyant SJF — the strong
    ordering baseline of the co-flow literature)."""

    def route(self, p, objective):
        idx, sets = path_sets(p)
        return idx, [cand[0] for cand in sets if cand]

    def pack(self, p, idx, paths):
        return _strict_priority_pack(p, idx, paths)


@dataclasses.dataclass(frozen=True)
class FairSharePolicy(Policy):
    """Fair sharing: shortest-path routing packed by temporal_pack's
    proportional water-filling — per-slot progressive filling is the
    max-min-lite fair allocation."""

    def route(self, p, objective):
        idx, sets = path_sets(p)
        return idx, [cand[0] for cand in sets if cand]


@dataclasses.dataclass(frozen=True)
class FairLpPolicy(Policy):
    """The LP fast path under the "fair" objective (weighted max-min
    fairness surrogate).  The one policy that runs PDHG — iters/tol/
    backend/device are honoured (as in solve_fast: "cuda" raises without
    a card); with uniform weights it coincides with the min-energy LP."""

    def solve(self, p, objective="energy", *, iters=3000,
              tol=None, backend="xla", device="cuda"):
        r = solve_fast(p, "fair", iters=iters or 3000, tol=tol,
                       backend=backend, device=device)
        return dataclasses.replace(
            r, certificate=verify.check_schedule(p, r.schedule))


POLICIES: dict[str, Policy] = {
    pol.name: pol for pol in (
        EcmpPolicy("ecmp", "hash routing over near-shortest path sets"),
        LeastLoadedPolicy("least-loaded",
                          "greedy min-bottleneck-utilization routing"),
        ShortestFirstPolicy("scf", "shortest-flow-first strict priority"),
        FairSharePolicy("fair", "max-min-lite fair-share water-filling"),
        FairLpPolicy("fair-lp", "weighted max-min fairness LP (PDHG)"),
    )
}


def get(name: str) -> Policy:
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; "
                       f"known: {', '.join(sorted(POLICIES))}")
    return POLICIES[name]
