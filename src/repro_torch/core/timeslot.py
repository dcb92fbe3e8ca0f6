"""Time-slotted co-flow scheduling problem + exact paper accounting.

A numpy copy of the reference `repro.core.timeslot`; `evaluate` is held
bitwise equal to it (tests/test_torch_problem.py).

This module defines the schedule decision tensors and evaluates any
candidate schedule with the paper's exact equations:

  * device activity / power:   eqs. (19)-(21)
  * total energy:              eq. (22)
  * completion time M:         eqs. (39)-(45)
  * feasibility:               eqs. (25)-(30), (46), (47)

A schedule is a pair of tensors
    x[f, e, w, t]  - Gbits of flow f carried on directed edge e,
                     wavelength w, during slot t
    (delta[f, t] = net injection is implied: sum of x out of src_f)
so every solver (the reference's exact MILP, the PDHG fast path in
core.solver) and any heuristic can be scored identically.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np

from .topology import KIND_SERVER, KIND_SWITCH, Topology
from .traffic import CoflowSet

TOL = 1e-6


@dataclasses.dataclass
class ScheduleProblem:
    """One co-flow scheduling instance: topology + demand + horizon.

    Units (paper Tables II-III): flow sizes and every schedule-tensor
    entry are **Gbits**; link capacities, `rho`, and `sigma` are **Gbps**
    (not GB/s — 1 Gbit = 0.125 GB); `slot_duration` is seconds, so a
    slot ships at most `cap * D` Gbits per (edge, wavelength).

    Construction is deterministic and side-effect free: `__post_init__`
    derives index arrays (`e_src`/`e_dst`, (F, E) `flow_edge_mask`,
    (E, W) `edge_w_ok`) from the topology alone — two problems built
    from equal inputs are interchangeable, which is what lets the sweep
    rebuild problems freely during its retry ladder."""

    topo: Topology
    coflow: CoflowSet
    n_slots: int                  # |T|
    rho: float = 8.0              # max egress rate per server, Gbps (Table III)
    q_weight: float = 100.0       # Q, earliest-slot fairness weight (Table III)
    # beyond-paper extension (TPU gradient buckets): flow f may not ship
    # before slot release_slot[f] (0-based).  None = all ready at t=0, which
    # is the paper's assumption for the shuffle phase.
    release_slot: np.ndarray | None = None
    # route pruning for sweep-scale solves: keep only edges on paths at most
    # `path_slack` hops longer than each flow's shortest route.  None keeps
    # the paper's full route space (any edge not touching src/dst wrongly).
    path_slack: int | None = None
    # weighted max-min fairness extension (arXiv 1904.03298 lineage): per-flow
    # positive weights for the "fair" LP objective — a flow's transport is
    # priced inversely to its weight, so heavier tenants get cheaper (hence
    # more) service.  None = uniform, which makes "fair" coincide with the
    # plain energy objective (pinned by tests/test_properties.py).
    flow_weight: np.ndarray | None = None

    def __post_init__(self):
        t = self.topo
        self.e_src = t.edges[:, 0].astype(np.int64)
        self.e_dst = t.edges[:, 1].astype(np.int64)
        self.is_server = np.array([d.kind == KIND_SERVER for d in t.devices])
        self.is_switch = np.array([d.kind == KIND_SWITCH for d in t.devices])
        self.p_max = np.array([d.p_max for d in t.devices])
        self.eps = np.array([d.eps for d in t.devices])
        self.sigma = np.array([t.switch_sigma.get(i, np.inf)
                               for i in range(t.n_vertices)])
        # flow-edge mask: 1 = flow f may use edge e
        F, E = self.coflow.n_flows, t.n_edges
        mask = np.ones((F, E), dtype=bool)
        src, dst = self.coflow.src, self.coflow.dst
        u_is_server = self.is_server[self.e_src]
        v_is_server = self.is_server[self.e_dst]
        # never re-enter the source / leave the destination
        mask &= ~(self.e_dst[None, :] == src[:, None])
        mask &= ~(self.e_src[None, :] == dst[:, None])
        if t.server_relay:
            # flows may pass through other servers (BCube/DCell/PON5), but a
            # transit server must be enterable+exitable; nothing more to mask.
            pass
        else:
            # eq. (46): servers never forward other servers' traffic (PON3)
            mask &= ~(u_is_server[None, :] & (self.e_src[None, :] != src[:, None]))
            mask &= ~(v_is_server[None, :] & (self.e_dst[None, :] != dst[:, None]))
        if self.path_slack is not None:
            dist = _hop_distances(t)
            # edge (u, v) stays admissible for flow f iff it lies on some
            # src->dst walk within path_slack hops of the shortest one
            through = (dist[src][:, self.e_src] + 1
                       + dist[:, dst].T[:, self.e_dst])
            mask &= through <= (dist[src, dst] + self.path_slack)[:, None]
        self.flow_edge_mask = mask
        # wavelength availability per edge
        self.edge_w_ok = t.cap > 0.0            # (E, W)
        if self.flow_weight is not None:
            w = np.asarray(self.flow_weight, dtype=np.float64)
            assert w.shape == (F,), (w.shape, F)
            assert np.isfinite(w).all() and (w > 0).all(), \
                "flow_weight entries must be positive and finite"
            self.flow_weight = w

    # -- convenience sizes --------------------------------------------------
    @property
    def shape_x(self) -> tuple[int, int, int, int]:
        return (self.coflow.n_flows, self.topo.n_edges,
                self.topo.n_wavelengths, self.n_slots)

    @property
    def slot_cap_gbits(self) -> np.ndarray:
        """(E, W) capacity in Gbits per slot: C_uvw * D (eq. 28)."""
        return self.topo.cap * self.topo.slot_duration


_KEEP = object()          # rehorizon sentinel: "leave path_slack alone"


def rehorizon(p: ScheduleProblem, n_slots: int, *,
              path_slack=_KEEP) -> ScheduleProblem:
    """Copy of `p` with a new horizon, skipping the derived-array rebuild.

    None of __post_init__'s products (edge endpoints, flow_edge_mask,
    edge_w_ok, device kind/power arrays) depend on n_slots, so when the
    route-pruning setting is unchanged the copy shares them with `p` —
    this is what the horizon-doubling retry ladders (sweep/runner.py,
    core.arrivals) call instead of re-deriving everything per retry.
    Passing a different `path_slack` (e.g. None to drop pruning) falls
    back to full construction, since the mask genuinely changes."""
    if path_slack is not _KEEP and path_slack != p.path_slack:
        return ScheduleProblem(p.topo, p.coflow, n_slots=n_slots,
                               rho=p.rho, q_weight=p.q_weight,
                               release_slot=p.release_slot,
                               path_slack=path_slack,
                               flow_weight=p.flow_weight)
    q = copy.copy(p)          # shallow: derived arrays are shared
    q.n_slots = n_slots
    return q


@dataclasses.dataclass
class Metrics:
    energy_j: float
    completion_s: float
    fairness_term: float          # Q * sum_t t*delta_{f,t}
    feasible: bool
    max_violation: float
    psi: np.ndarray               # (E, W, T) total per-link traffic, Gbits
    active_devices: np.ndarray    # (V, W, T) bool
    served: np.ndarray            # (F,) Gbits delivered

    def objective(self, kind: str) -> float:
        # "fair" is a weighted re-pricing of the energy LP (core.solver),
        # so its exact-accounting base is energy too
        base = (self.completion_s if kind == "time" else self.energy_j)
        return base + self.fairness_term


def _hop_distances(topo: Topology) -> np.ndarray:
    """(V, V) directed hop-count distance matrix (BFS per vertex),
    memoized on the topology instance — sweeps build hundreds of
    ScheduleProblems over the same handful of graphs."""
    cached = getattr(topo, "_hop_dist_cache", None)
    if cached is not None:
        return cached
    V = topo.n_vertices
    nbrs: list[list[int]] = [[] for _ in range(V)]
    # dead edges (all-zero capacity, e.g. cut by core.failures) are not
    # traversable — distances must reflect the degraded connectivity
    alive = topo.cap.sum(axis=1) > 0.0
    for e, (u, v) in enumerate(topo.edges):
        if alive[e]:
            nbrs[int(u)].append(int(v))
    dist = np.full((V, V), np.inf)
    for s in range(V):
        dist[s, s] = 0.0
        frontier = [s]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in nbrs[u]:
                    if dist[s, v] > d:
                        dist[s, v] = d
                        nxt.append(v)
            frontier = nxt
    topo._hop_dist_cache = dist
    return dist


def suggest_n_slots(topo: Topology, coflow: CoflowSet, *, rho: float = 8.0,
                    slack: float = 2.0, extra: int = 2) -> int:
    """Horizon heuristic for sweep-scale problems: a continuous-time lower
    bound on the shuffle makespan (max over vertices of offered Gbits
    divided by the tighter of the egress-rate cap rho and the incident
    per-wavelength link capacity), stretched by `slack` to give the greedy
    slot packer headroom, plus `extra` slots."""
    out_g = np.zeros(topo.n_vertices)
    in_g = np.zeros(topo.n_vertices)
    np.add.at(out_g, coflow.src, coflow.size)
    np.add.at(in_g, coflow.dst, coflow.size)
    cap_out = np.zeros(topo.n_vertices)
    cap_in = np.zeros(topo.n_vertices)
    per_edge = topo.cap.sum(axis=1)
    np.add.at(cap_out, topo.edges[:, 0], per_edge)
    np.add.at(cap_in, topo.edges[:, 1], per_edge)
    rate_out = np.minimum(np.maximum(cap_out, 1e-9), rho)
    rate_in = np.maximum(cap_in, 1e-9)
    t_lb = max(float((out_g / rate_out).max(initial=0.0)),
               float((in_g / rate_in).max(initial=0.0)))
    return max(int(np.ceil(slack * t_lb / topo.slot_duration)) + extra, 2)


def _delta_from_x(p: ScheduleProblem, x: np.ndarray) -> np.ndarray:
    """delta[f, t] = net injection at the source of flow f in slot t."""
    F, E, W, T = p.shape_x
    out_src = np.zeros((F, T))
    in_src = np.zeros((F, T))
    for f in range(F):
        s = p.coflow.src[f]
        out_src[f] = x[f, p.e_src == s].sum(axis=(0, 1))
        in_src[f] = x[f, p.e_dst == s].sum(axis=(0, 1))
    return out_src - in_src


def _activity_energy(p: ScheduleProblem, psi: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, float]:
    """Device activity + energy (eqs. 19-22) of an (E, W, T') traffic
    tensor: per-vertex carried traffic beta, the ON mask, and total
    Joules.  Single source of truth for evaluate (T' = full horizon)
    and prefix_energy (T' = an executed epoch prefix)."""
    D = p.topo.slot_duration
    beta = np.zeros((p.topo.n_vertices,) + psi.shape[1:])
    np.add.at(beta, p.e_src, psi)
    np.add.at(beta, p.e_dst, psi)
    active = beta > TOL
    energy = D * float((active * p.p_max[:, None, None]).sum())
    energy += D * float((p.eps[:, None, None] * beta
                         * p.is_server[:, None, None]).sum())
    return beta, active, energy


def prefix_energy(p: ScheduleProblem, x: np.ndarray, t_end: int) -> float:
    """Exact eq. (19)-(22) energy of the first `t_end` slots of x —
    evaluate()'s accounting applied to a schedule prefix (the online
    arrival engine re-plans the suffix, so only executed slots may burn
    Joules)."""
    return _activity_energy(p, x[:, :, :, :t_end].sum(axis=0))[2]


def evaluate(p: ScheduleProblem, x: np.ndarray) -> Metrics:
    """Exact accounting of a schedule tensor with the paper's equations.

    `x` has shape (F, E, W, T) in Gbits; returns energy in Joules
    (eqs. 19-22), completion time in seconds (eqs. 39-45), and the worst
    constraint violation in Gbits (feasible iff <= 1e-4).  Pure numpy,
    deterministic, and backend-independent — this is the single source
    of truth both solver backends and all sweeps report through."""
    F, E, W, T = p.shape_x
    assert x.shape == (F, E, W, T), (x.shape, p.shape_x)
    D = p.topo.slot_duration
    psi = x.sum(axis=0)                              # (E, W, T), eq. (29)

    viol = 0.0
    # eq. (28): psi <= C*D   (W entries with zero capacity must carry nothing)
    viol = max(viol, float((psi - p.slot_cap_gbits[:, :, None]).max(initial=0.0)))
    # eq. (26): server egress <= rho*D
    egress = np.zeros((p.topo.n_vertices, T))
    np.add.at(egress, p.e_src, psi.sum(axis=1))
    viol = max(viol, float((egress[p.is_server] - p.rho * D).max(initial=0.0)))
    # eq. (27): switch ingress <= sigma*D
    ingress = np.zeros((p.topo.n_vertices, T))
    np.add.at(ingress, p.e_dst, psi.sum(axis=1))
    sw = p.is_switch & np.isfinite(p.sigma)
    viol = max(viol, float((ingress[sw] - p.sigma[sw, None] * D).max(initial=0.0)))
    # flow-edge mask (eq. 46 et al.)
    viol = max(viol, float((x * ~p.flow_edge_mask[:, :, None, None]).max(initial=0.0)))

    # eq. (25): conservation at intermediate vertices.  Passive vertices
    # (AWGR ports) conserve per wavelength (no O/E conversion); electronic
    # vertices (switches/OLT/backplanes/relay servers) may convert, so they
    # conserve the wavelength-summed flow.
    passive = ~(p.is_server | p.is_switch)
    for f in range(F):
        net = np.zeros((p.topo.n_vertices, W, T))
        np.add.at(net, p.e_src, x[f])
        np.subtract.at(net, p.e_dst, x[f])
        inter = np.ones(p.topo.n_vertices, dtype=bool)
        inter[p.coflow.src[f]] = inter[p.coflow.dst[f]] = False
        viol = max(viol, float(np.abs(net[inter & passive]).max(initial=0.0)))
        viol = max(viol, float(np.abs(net.sum(axis=1)[inter]).max(initial=0.0)))

    # eq. (30): demand satisfaction (report shortfall as violation)
    delta = _delta_from_x(p, x)
    served = delta.sum(axis=1)
    viol = max(viol, float(np.abs(served - p.coflow.size).max(initial=0.0)))

    # release times (extension): no traffic before a flow's release slot
    if p.release_slot is not None:
        for f in range(F):
            r = int(p.release_slot[f])
            if r > 0:
                viol = max(viol, float(x[f, :, :, :r].max(initial=0.0)))

    # eq. (47): one TX wavelength per server per slot (PON3)
    if p.topo.one_wavelength_tx and p.topo.awgr_in_ports:
        awgr_in = np.isin(p.e_dst, p.topo.awgr_in_ports)
        for i in np.flatnonzero(p.is_server):
            sel = (p.e_src == i) & awgr_in
            if sel.any():
                n_w_used = (psi[sel].sum(axis=0) > TOL).sum(axis=0)  # (T,)
                viol = max(viol, float(n_w_used.max(initial=0) - 1))

    # device activity (eqs. 31-38) and power (eqs. 19-21)
    beta, active, energy = _activity_energy(p, psi)       # eq. (22)

    # completion time M (eqs. 39-45): last active link's in-slot finish time
    with np.errstate(divide="ignore", invalid="ignore"):
        tx_time = np.where(psi > TOL,
                           psi / np.maximum(p.topo.cap[:, :, None], 1e-30), 0.0)
    t_idx = np.arange(1, T + 1)[None, None, :]
    omega = np.where(psi > TOL, D * (t_idx - 1) + tx_time, 0.0)   # eq. (39)
    completion = float(omega.max(initial=0.0))                    # eqs. (43-45)

    fairness = p.q_weight * float((delta * t_idx[0, 0][None, :]).sum())
    return Metrics(energy_j=energy, completion_s=completion,
                   fairness_term=fairness, feasible=viol <= 1e-4,
                   max_violation=viol, psi=psi,
                   active_devices=active, served=served)
