"""Exact MILP oracle for the time-slotted co-flow model (paper §V).

Builds the paper's MILP verbatim (variables x^{sd}_{uvwt}, delta_{sdt},
B_{iwt}, A_{iwt}, Gamma_{uvwt}, M; constraints eqs. 25-47) and solves it
with scipy's HiGHS backend.  This is the reproduction reference: the
fast path (core.solver) is benchmarked against it, and tests assert the
fast path's schedules are feasible with bounded optimality gap.  A copy
of the reference's repro.core.oracle (numpy and scipy only), held equal
to it by tests/test_torch_sweep.py; the sweep's --oracle-check uses it.

CPLEX (paper) -> HiGHS (here): both branch-and-cut exact solvers; a
`time_limit`/`mip_rel_gap` makes large instances practical and the
reported gap is recorded alongside every result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import numpy as np
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint, milp

from .timeslot import Metrics, ScheduleProblem, evaluate


@contextlib.contextmanager
def _quiet_cstdout():
    """Silence HiGHS's C-level stdout/stderr chatter (it bypasses the
    Python streams and would pollute benchmark CSVs)."""
    saved = []
    try:
        for stream in (sys.stdout, sys.stderr):
            stream.flush()
            fd = stream.fileno()
            saved.append((fd, os.dup(fd)))
    except (ValueError, OSError):
        for fd, dup in saved:
            os.close(dup)
        yield
        return
    try:
        with open(os.devnull, "wb") as devnull:
            for fd, _ in saved:
                os.dup2(devnull.fileno(), fd)
            yield
    finally:
        for fd, dup in saved:
            os.dup2(dup, fd)
            os.close(dup)

BIG_M_SLACK = 1.0  # completion-time big-M headroom (s)


@dataclasses.dataclass
class OracleResult:
    schedule: np.ndarray          # x[f,e,w,t]
    metrics: Metrics
    objective_value: float
    mip_gap: float
    status: int
    message: str


def _build_index(p: ScheduleProblem):
    """Enumerate admissible (flow, edge, wavelength) triples."""
    F, E, W, T = p.shape_x
    af, ae = np.nonzero(p.flow_edge_mask)
    # expand wavelengths per edge
    ks_f, ks_e, ks_w = [], [], []
    for f, e in zip(af, ae):
        ws = np.nonzero(p.edge_w_ok[e])[0]
        ks_f.append(np.full(len(ws), f))
        ks_e.append(np.full(len(ws), e))
        ks_w.append(ws)
    kf = np.concatenate(ks_f) if ks_f else np.zeros(0, np.int64)
    ke = np.concatenate(ks_e) if ks_e else np.zeros(0, np.int64)
    kw = np.concatenate(ks_w) if ks_w else np.zeros(0, np.int64)
    return kf.astype(np.int64), ke.astype(np.int64), kw.astype(np.int64)


def solve_lexico(p: ScheduleProblem, objective: str = "energy", *,
                 time_limit: float | None = 120.0,
                 mip_rel_gap: float = 1e-4,
                 slack: float = 1e-4) -> OracleResult:
    """Two-stage lexicographic solve: (1) minimize the primary objective
    alone; (2) minimize the earliest-slot fairness term Q*sum(t*delta)
    subject to primary <= opt*(1+slack).

    The paper folds both into one weighted objective (eqs. 23/24,
    Q = 100); at paper traffic scales the fairness term numerically
    dominates the primary one, so branch-and-bound gap tolerances bind
    on fairness rather than on E or M.  The lexicographic equivalent
    realizes the paper's stated intent ("reduce completion time ... as a
    lower priority") with exact primaries."""
    import dataclasses as _dc
    p1 = _dc.replace(p, q_weight=0.0)
    r1 = solve(p1, objective, time_limit=time_limit, mip_rel_gap=mip_rel_gap)
    primary = (r1.metrics.energy_j if objective == "energy"
               else r1.metrics.completion_s)
    r2 = solve(p, objective, time_limit=time_limit, mip_rel_gap=mip_rel_gap,
               cap_primary=primary * (1.0 + slack) + 1e-9,
               fairness_only=True)
    return r2


def solve(p: ScheduleProblem, objective: str = "energy", *,
          time_limit: float | None = 120.0,
          mip_rel_gap: float = 1e-3,
          cap_primary: float | None = None,
          fairness_only: bool = False) -> OracleResult:
    assert objective in ("energy", "time")
    F, E, W, T = p.shape_x
    D = p.topo.slot_duration
    kf, ke, kw = _build_index(p)
    K = len(kf)

    # ---- variable layout -------------------------------------------------
    # x[k, t] -> k*T + t
    n_x = K * T
    off_delta = n_x                                   # delta[f, t]
    n_delta = F * T
    servers = np.flatnonzero(p.is_server)
    switches = np.flatnonzero(p.is_switch & (p.p_max > 0))
    off_B = off_delta + n_delta                       # B[si, w, t]
    n_B = len(servers) * W * T
    off_A = off_B + n_B                               # A[wi, w, t]
    n_A = len(switches) * W * T
    # Gamma on admissible (e, w) pairs only
    ge, gw = np.nonzero(p.edge_w_ok)
    G = len(ge)
    need_gamma = objective == "time" or p.topo.one_wavelength_tx
    off_G = off_A + n_A
    n_G = G * T if need_gamma else 0
    off_M = off_G + n_G
    n_M = 1 if objective == "time" else 0
    n_var = off_M + n_M

    sidx = {int(s): i for i, s in enumerate(servers)}
    widx = {int(s): i for i, s in enumerate(switches)}
    gidx = {(int(e), int(w)): i for i, (e, w) in enumerate(zip(ge, gw))}

    def vx(k, t):
        return k * T + t

    def vdelta(f, t):
        return off_delta + f * T + t

    def vB(si, w, t):
        return off_B + (si * W + w) * T + t

    def vA(wi, w, t):
        return off_A + (wi * W + w) * T + t

    def vG(g, t):
        return off_G + g * T + t

    rows, cols, vals = [], [], []
    lb_rows, ub_rows = [], []
    n_rows = 0

    def add_row(cs, vs, lo, hi):
        nonlocal n_rows
        rows.extend([n_rows] * len(cs))
        cols.extend(cs)
        vals.extend(vs)
        lb_rows.append(lo)
        ub_rows.append(hi)
        n_rows += 1

    e_src, e_dst = p.e_src, p.e_dst
    cap = p.topo.cap
    slot_cap = p.slot_cap_gbits                       # (E, W)

    # ---- eq. (25): conservation -------------------------------------------
    # Passive vertices (AWGR ports) conserve per wavelength; electronic
    # vertices may O/E-convert and conserve the wavelength-summed flow.
    passive = ~(p.is_server | p.is_switch)
    ks_by_flow = [np.flatnonzero(kf == f) for f in range(F)]
    for f in range(F):
        s, d = int(p.coflow.src[f]), int(p.coflow.dst[f])
        ks = ks_by_flow[f]
        out_v = e_src[ke[ks]]
        in_v = e_dst[ke[ks]]
        for t in range(T):
            # source row (summed over wavelengths): out - in - delta = 0
            cs = ([vx(int(k), t) for k in ks[out_v == s]]
                  + [vx(int(k), t) for k in ks[in_v == s]]
                  + [vdelta(f, t)])
            vs = ([1.0] * int((out_v == s).sum())
                  + [-1.0] * int((in_v == s).sum()) + [-1.0])
            add_row(cs, vs, 0.0, 0.0)
            # intermediate vertices
            for u in np.unique(np.concatenate([out_v, in_v])):
                if u == s or u == d:
                    continue
                w_groups = ([ [w] for w in range(W) ] if passive[u]
                            else [list(range(W))])
                for wg in w_groups:
                    sel_o = ks[(out_v == u) & np.isin(kw[ks], wg)]
                    sel_i = ks[(in_v == u) & np.isin(kw[ks], wg)]
                    if len(sel_o) == 0 and len(sel_i) == 0:
                        continue
                    cs = ([vx(int(k), t) for k in sel_o]
                          + [vx(int(k), t) for k in sel_i])
                    vs = [1.0] * len(sel_o) + [-1.0] * len(sel_i)
                    add_row(cs, vs, 0.0, 0.0)

    # ---- eq. (30): demand --------------------------------------------------
    for f in range(F):
        add_row([vdelta(f, t) for t in range(T)], [1.0] * T,
                float(p.coflow.size[f]), float(p.coflow.size[f]))

    # ---- eq. (28): link capacity; plus Gamma coupling (eqs. 37-38) ---------
    ks_by_ew: dict[tuple[int, int], list[int]] = {}
    for k in range(K):
        ks_by_ew.setdefault((int(ke[k]), int(kw[k])), []).append(k)
    for (e, w), ks in ks_by_ew.items():
        for t in range(T):
            cs = [vx(k, t) for k in ks]
            if need_gamma:
                g = gidx[(e, w)]
                add_row(cs + [vG(g, t)], [1.0] * len(ks) + [-slot_cap[e, w]],
                        -np.inf, 0.0)                 # psi <= C*D*Gamma
            else:
                add_row(cs, [1.0] * len(ks), -np.inf, float(slot_cap[e, w]))

    # ---- eq. (26)/(27): server egress & switch ingress rate caps -----------
    for i in servers:
        ks = [k for k in range(K) if e_src[ke[k]] == i]
        if not ks:
            continue
        for t in range(T):
            add_row([vx(k, t) for k in ks], [1.0] * len(ks),
                    -np.inf, p.rho * D)
    for i in np.flatnonzero(p.is_switch):
        if not np.isfinite(p.sigma[i]):
            continue
        ks = [k for k in range(K) if e_dst[ke[k]] == i]
        if not ks:
            continue
        for t in range(T):
            add_row([vx(k, t) for k in ks], [1.0] * len(ks),
                    -np.inf, float(p.sigma[i]) * D)

    # ---- eqs. (31)-(36): device-activity big-M links ------------------------
    # beta_iwt = incident traffic; beta <= L * B  with tight L = incident cap * D
    inc_cap = np.zeros((p.topo.n_vertices, W))
    np.add.at(inc_cap, e_src, cap)
    np.add.at(inc_cap, e_dst, cap)
    for i in servers:
        si = sidx[int(i)]
        ks = [k for k in range(K) if e_src[ke[k]] == i or e_dst[ke[k]] == i]
        for w in range(W):
            ksw = [k for k in ks if kw[k] == w]
            L = float(inc_cap[i, w]) * D
            if not ksw or L <= 0:
                continue
            for t in range(T):
                add_row([vx(k, t) for k in ksw] + [vB(si, w, t)],
                        [1.0] * len(ksw) + [-L], -np.inf, 0.0)
    for i in switches:
        wi = widx[int(i)]
        ks = [k for k in range(K) if e_src[ke[k]] == i or e_dst[ke[k]] == i]
        for w in range(W):
            ksw = [k for k in ks if kw[k] == w]
            L = float(inc_cap[i, w]) * D
            if not ksw or L <= 0:
                continue
            for t in range(T):
                add_row([vx(k, t) for k in ksw] + [vA(wi, w, t)],
                        [1.0] * len(ksw) + [-L], -np.inf, 0.0)

    # ---- eq. (47): one TX wavelength per PON3 server per slot ---------------
    if p.topo.one_wavelength_tx and p.topo.awgr_in_ports:
        awgr_in = set(p.topo.awgr_in_ports)
        for i in servers:
            egs = [(e, w) for (e, w) in gidx
                   if e_src[e] == i and int(e_dst[e]) in awgr_in]
            if not egs:
                continue
            for t in range(T):
                add_row([vG(gidx[ew], t) for ew in egs], [1.0] * len(egs),
                        -np.inf, 1.0)

    # ---- eqs. (39)-(45): completion time (time objective only) -------------
    if objective == "time":
        LM = D * T + BIG_M_SLACK
        for (e, w), g in gidx.items():
            ks = ks_by_ew.get((e, w), [])
            if not ks:
                continue
            for t in range(T):
                # M >= D*t + psi/C - LM*(1 - Gamma)   (t is 0-based here)
                cs = [vx(k, t) for k in ks] + [vG(g, t), off_M]
                vs = [-1.0 / cap[e, w]] * len(ks) + [-LM, 1.0]
                add_row(cs, vs, D * t - LM, np.inf)

    # ---- objective -----------------------------------------------------------
    c_fair = np.zeros(n_var)
    t_rank = np.arange(1, T + 1)
    qw = p.q_weight if (p.q_weight or not fairness_only) else 1.0
    for f in range(F):
        c_fair[off_delta + f * T: off_delta + (f + 1) * T] += qw * t_rank

    c_prim = np.zeros(n_var)
    if objective == "energy":
        for i in servers:
            si = sidx[int(i)]
            for w in range(W):
                for t in range(T):
                    c_prim[vB(si, w, t)] += D * p.p_max[i]
        for i in switches:
            wi = widx[int(i)]
            for w in range(W):
                for t in range(T):
                    c_prim[vA(wi, w, t)] += D * p.p_max[i]
        # eps * beta NIC term: D * eps_i * (incident x)
        for k in range(K):
            e = ke[k]
            w_eps = 0.0
            if p.is_server[e_src[e]]:
                w_eps += p.eps[e_src[e]]
            if p.is_server[e_dst[e]]:
                w_eps += p.eps[e_dst[e]]
            if w_eps:
                for t in range(T):
                    c_prim[vx(k, t)] += D * w_eps
    else:
        c_prim[off_M] = 1.0

    if cap_primary is not None:
        nz = np.nonzero(c_prim)[0]
        add_row(list(nz), list(c_prim[nz]), -np.inf, float(cap_primary))
    c = c_fair if fairness_only else c_prim + c_fair

    # ---- assemble and solve ---------------------------------------------------
    A = sparse.csr_matrix(
        (np.asarray(vals), (np.asarray(rows), np.asarray(cols))),
        shape=(n_rows, n_var))
    lb = np.zeros(n_var)
    ub = np.full(n_var, np.inf)
    # release times (extension): flow f carries nothing before its slot
    if p.release_slot is not None:
        for f in range(F):
            r = int(p.release_slot[f])
            for t in range(min(r, T)):
                ub[vdelta(f, t)] = 0.0
                for k in np.flatnonzero(kf == f):
                    ub[vx(int(k), t)] = 0.0
    integrality = np.zeros(n_var)
    for off, n in ((off_B, n_B), (off_A, n_A), (off_G, n_G)):
        ub[off:off + n] = 1.0
        integrality[off:off + n] = 1
    with _quiet_cstdout():
        res = milp(c=c,
                   constraints=LinearConstraint(A, np.asarray(lb_rows),
                                                np.asarray(ub_rows)),
                   bounds=Bounds(lb, ub), integrality=integrality,
                   options={"time_limit": time_limit,
                            "mip_rel_gap": mip_rel_gap,
                            "presolve": True})
    if res.x is None:
        raise RuntimeError(f"oracle failed: {res.message}")

    x = np.zeros(p.shape_x)
    xt = res.x[:n_x].reshape(K, T)
    np.add.at(x, (kf, ke, kw), xt)
    x[np.abs(x) < 1e-9] = 0.0
    metrics = evaluate(p, x)
    gap = float(res.mip_gap) if res.mip_gap is not None else np.nan
    return OracleResult(schedule=x, metrics=metrics,
                        objective_value=float(res.fun),
                        mip_gap=gap, status=int(res.status),
                        message=str(res.message))
