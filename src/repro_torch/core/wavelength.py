"""AWGR-centric cell wiring + wavelength assignment MILP (paper §III).

A copy of the reference `repro.core.wavelength` (numpy and scipy only),
held equal to it by tests/test_torch_fabric.py.

Reproduces the paper's eqs. (1)-(18): choose the physical wiring of rack
and OLT ports to two MxM AWGRs (beta), and per ordered communicating pair
(s, d) a wavelength (mu) and a wavelength-continuous route (chi), to
maximize the number of achieved connections.  The paper's instance
(4 racks + 1 OLT, two 4x4 AWGRs, 4 wavelengths) achieves all
G*(G-1) = 20 connections (Table I / Fig. 3).

The flow variables chi relax to [0, 1]; integrality of the solution is
asserted post-hoc (unit-capacity path structure), while beta / mu stay
binary.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint, milp


@dataclasses.dataclass
class CellDesign:
    n_racks: int = 4
    n_olt: int = 1
    n_awgrs: int = 2

    @property
    def G(self) -> int:
        return self.n_racks + self.n_olt

    @property
    def M(self) -> int:          # AWGR size = wavelengths needed = G-1
        return self.G - 1

    @property
    def n_wavelengths(self) -> int:
        return self.G - 1


@dataclasses.dataclass
class WavelengthSolution:
    achieved: int                     # number of connected ordered pairs
    lam: np.ndarray                   # (G, G) wavelength index or -1
    hops: np.ndarray                  # (G, G) AWGR hop count or 0
    beta: dict[tuple[str, str], int]  # chosen wiring
    integral: bool


def _ports(d: CellDesign):
    """Vertex naming: P vertices then AWGR ports."""
    verts: list[str] = []
    P = [f"rack{r}" for r in range(d.n_racks)] + [f"olt{o}" for o in range(d.n_olt)]
    verts += P
    I: dict[int, list[str]] = {}
    O: dict[int, list[str]] = {}
    for k in range(d.n_awgrs):
        I[k] = [f"a{k}i{m}" for m in range(d.M)]
        O[k] = [f"a{k}o{m}" for m in range(d.M)]
        verts += I[k] + O[k]
    return verts, P, I, O


def solve(d: CellDesign = CellDesign(), *, time_limit: float = 300.0,
          mip_rel_gap: float = 1e-6) -> WavelengthSolution:
    verts, P, I, O = _ports(d)
    vid = {v: i for i, v in enumerate(verts)}
    W = d.n_wavelengths
    pairs = [(s, dd) for s in P for dd in P if s != dd]

    # candidate physical links (the paper's "initial topology")
    links: list[tuple[str, str]] = []
    for p in P:
        for k in range(d.n_awgrs):
            links += [(p, n) for n in I[k]]          # P egress -> AWGR in
            links += [(n, p) for n in O[k]]          # AWGR out -> P ingress
    for k in range(d.n_awgrs):
        links += [(m, n) for m in I[k] for n in O[k]]  # internal (always wired)
        for q in range(d.n_awgrs):
            if q != k:
                links += [(m, n) for m in O[k] for n in I[q]]  # inter-AWGR
    lid = {l: i for i, l in enumerate(links)}
    L = len(links)
    internal = [lid[(m, n)] for k in range(d.n_awgrs)
                for m in I[k] for n in O[k]]

    # ---- variable layout: beta | mu | chi ---------------------------------
    n_beta = L
    n_mu = len(pairs) * W
    n_chi = len(pairs) * W * L
    n = n_beta + n_mu + n_chi

    def vbeta(l):
        return l

    def vmu(pi, j):
        return n_beta + pi * W + j

    def vchi(pi, j, l):
        return n_beta + n_mu + (pi * W + j) * L + l

    rows, cols, vals, lo, hi = [], [], [], [], []
    nr = 0

    def add(cs, vs, l, h):
        nonlocal nr
        rows.extend([nr] * len(cs)); cols.extend(cs); vals.extend(vs)
        lo.append(l); hi.append(h); nr += 1

    out_l = {v: [] for v in verts}
    in_l = {v: [] for v in verts}
    for (m, nn), l in lid.items():
        out_l[m].append(l)
        in_l[nn].append(l)

    # eq. (2): flow conservation per (pair, vertex, wavelength)
    for pi, (s, dd) in enumerate(pairs):
        for j in range(W):
            for v in verts:
                cs = ([vchi(pi, j, l) for l in out_l[v]]
                      + [vchi(pi, j, l) for l in in_l[v]])
                vs = [1.0] * len(out_l[v]) + [-1.0] * len(in_l[v])
                if v == s:
                    cs.append(vmu(pi, j)); vs.append(-1.0)
                    add(cs, vs, 0.0, 0.0)
                elif v == dd:
                    cs.append(vmu(pi, j)); vs.append(1.0)
                    add(cs, vs, 0.0, 0.0)
                else:
                    add(cs, vs, 0.0, 0.0)

    # eq. (3): one wavelength per pair
    for pi in range(len(pairs)):
        add([vmu(pi, j) for j in range(W)], [1.0] * W, -np.inf, 1.0)
    # eq. (4): destination receives each wavelength from at most one source
    for dd in P:
        for j in range(W):
            cs = [vmu(pi, j) for pi, (s2, d2) in enumerate(pairs) if d2 == dd]
            add(cs, [1.0] * len(cs), -np.inf, 1.0)
    # eq. (5): source transmits each wavelength to at most one destination
    for s in P:
        for j in range(W):
            cs = [vmu(pi, j) for pi, (s2, d2) in enumerate(pairs) if s2 == s]
            add(cs, [1.0] * len(cs), -np.inf, 1.0)

    # eq. (6): vertices in P do not relay connections of others
    for i_v in P:
        cs, vs = [], []
        for pi in range(len(pairs)):
            for j in range(W):
                for l in out_l[i_v]:
                    cs.append(vchi(pi, j, l)); vs.append(1.0)
        for pi, (s2, d2) in enumerate(pairs):
            if s2 == i_v:
                for j in range(W):
                    cs.append(vmu(pi, j)); vs.append(-1.0)
        add(cs, vs, -np.inf, 0.0)

    # eq. (8): each internal AWGR path carries at most one (pair, wavelength)
    for l in internal:
        cs = [vchi(pi, j, l) for pi in range(len(pairs)) for j in range(W)]
        add(cs, [1.0] * len(cs), -np.inf, 1.0)

    # eq. (9): traffic only on chosen links
    for l in range(L):
        for j in range(W):
            cs = ([vchi(pi, j, l) for pi in range(len(pairs))]
                  + [vbeta(l)])
            add(cs, [1.0] * len(pairs) + [-1.0], -np.inf, 0.0)

    # eqs. (10)-(13): each rack one AWGR ingress + one egress (total);
    # OLT one ingress + one egress per AWGR
    for r in [f"rack{i}" for i in range(d.n_racks)]:
        add([vbeta(lid[(r, nn)]) for k in range(d.n_awgrs) for nn in I[k]],
            [1.0] * (d.n_awgrs * d.M), 1.0, 1.0)
        add([vbeta(lid[(nn, r)]) for k in range(d.n_awgrs) for nn in O[k]],
            [1.0] * (d.n_awgrs * d.M), 1.0, 1.0)
    for o in [f"olt{i}" for i in range(d.n_olt)]:
        for k in range(d.n_awgrs):
            add([vbeta(lid[(o, nn)]) for nn in I[k]], [1.0] * d.M, -np.inf, 1.0)
            add([vbeta(lid[(nn, o)]) for nn in O[k]], [1.0] * d.M, -np.inf, 1.0)

    # eqs. (14)-(15): unique connection per AWGR port
    for k in range(d.n_awgrs):
        for nn in I[k]:
            cs = [vbeta(lid[(m, nn)]) for m in P]
            for q in range(d.n_awgrs):
                if q != k:
                    cs += [vbeta(lid[(m, nn)]) for m in O[q]]
            add(cs, [1.0] * len(cs), -np.inf, 1.0)
        for nn in O[k]:
            cs = [vbeta(lid[(nn, m)]) for m in P]
            for q in range(d.n_awgrs):
                if q != k:
                    cs += [vbeta(lid[(nn, m)]) for m in I[q]]
            add(cs, [1.0] * len(cs), -np.inf, 1.0)

    # eq. (17): inter-AWGR cables: exactly M/2 - 1 per direction
    for k in range(d.n_awgrs):
        for q in range(d.n_awgrs):
            if q == k:
                continue
            cs = [vbeta(lid[(m, nn)]) for m in O[k] for nn in I[q]]
            add(cs, [1.0] * len(cs), -np.inf, d.M / 2 - 1)

    # ---- objective: maximize achieved connections -------------------------
    c = np.zeros(n)
    for pi in range(len(pairs)):
        for j in range(W):
            c[vmu(pi, j)] = -1.0

    lb = np.zeros(n)
    ub = np.ones(n)
    for l in internal:
        lb[vbeta(l)] = 1.0            # eq. (16)
    integrality = np.zeros(n)
    integrality[:n_beta + n_mu] = 1   # beta, mu binary; chi relaxed

    from .oracle import _quiet_cstdout
    A = sparse.csr_matrix((vals, (rows, cols)), shape=(nr, n))
    with _quiet_cstdout():
        res = milp(c=c, constraints=LinearConstraint(A, lo, hi),
                   bounds=Bounds(lb, ub), integrality=integrality,
                   options={"time_limit": time_limit,
                            "mip_rel_gap": mip_rel_gap})
    if res.x is None:
        raise RuntimeError(f"wavelength MILP failed: {res.message}")

    chi = res.x[n_beta + n_mu:].reshape(len(pairs) * W, L)
    integral = bool(np.all(np.minimum(np.abs(chi), np.abs(chi - 1.0)) < 1e-6))
    mu = res.x[n_beta:n_beta + n_mu].reshape(len(pairs), W)
    lam = -np.ones((d.G, d.G), dtype=int)
    hops = np.zeros((d.G, d.G), dtype=int)
    pidx = {v: i for i, v in enumerate(P)}
    for pi, (s, dd) in enumerate(pairs):
        js = np.flatnonzero(mu[pi] > 0.5)
        if len(js):
            j = int(js[0])
            lam[pidx[s], pidx[dd]] = j
            used = np.flatnonzero(chi[pi * W + j] > 0.5)
            hops[pidx[s], pidx[dd]] = sum(
                1 for l in used if l in set(internal))
    beta = {links[l]: 1 for l in range(L) if res.x[l] > 0.5}
    return WavelengthSolution(achieved=int(-res.fun + 0.5), lam=lam,
                              hops=hops, beta=beta, integral=integral)
