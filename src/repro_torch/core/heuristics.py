"""Baseline schedulers the co-flow literature compares against.

A numpy copy of the reference `repro.core.heuristics`; schedules are
held bitwise equal to it (tests/test_torch_fabric.py).

The paper motivates co-flow-aware scheduling via Varys [22], which
reports 3.66x / 5.53x / 5.65x completion-time improvements over fair
sharing, per-flow prioritization, and FIFO.  These baselines let the
benchmarks quantify the same effect inside OUR model: each baseline
fixes the *order/rates* by its own rule, routes each flow on its
shortest path (no load-aware routing), and is then scored by the exact
paper accounting (core.timeslot.evaluate).

  fifo        flows transmit one at a time in arrival (index) order
  fair        all active flows share every link equally (max-min-lite,
              progressive filling per slot)
  sebf        smallest effective bottleneck first (Varys-like co-flow
              clairvoyant heuristic) — included as the strong baseline
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .timeslot import ScheduleProblem


def _shortest_paths(p: ScheduleProblem):
    """Per flow: BFS shortest admissible path (hop count), as triple lists
    compatible with the wavelength-continuity rules."""
    from .solver import FlowPath, RoutingIndex, _admissible, _out_edges
    kf, ke, kw = _admissible(p)
    passive = ~(p.is_server | p.is_switch)
    E, W = p.topo.n_edges, p.topo.n_wavelengths
    out_edges = _out_edges(p)                 # memoized per topology
    F = p.coflow.n_flows
    # kf is sorted (lexicographic triples): each flow owns one contiguous
    # slice; a dense (E, W) scratch map replaces the historical
    # (f, e, w)-keyed admissibility set / triple-lookup dicts
    bounds = np.searchsorted(kf, np.arange(F + 1))
    k_map = np.full((E, W), -1, dtype=np.int64)

    paths = []
    for f in range(F):
        lo, hi = bounds[f], bounds[f + 1]
        es, ws = ke[lo:hi], kw[lo:hi]
        k_map[es, ws] = np.arange(lo, hi)
        src, dst = int(p.coflow.src[f]), int(p.coflow.dst[f])
        # BFS over (vertex, wavelength-in) states; deque gives O(1)
        # popleft (a list's pop(0) is O(queue) per visit, O(states^2) total)
        start = (src, -1)
        prev = {start: None}
        queue = deque([start])
        goal = None
        while queue and goal is None:
            u, w_in = queue.popleft()
            convert = (w_in == -1) or not passive[u]
            for e in out_edges[u]:
                for w in range(W):
                    if not convert and w != w_in:
                        continue
                    if k_map[e, w] < 0:
                        continue
                    v = int(p.e_dst[e])
                    state = (v, w)
                    if state in prev:
                        continue
                    prev[state] = ((u, w_in), e, w)
                    if v == dst:
                        goal = state
                        break
                    queue.append(state)
                if goal:
                    break
        if goal is None:
            raise RuntimeError(f"flow {f}: no admissible path")
        trail = []
        st = goal
        while prev[st] is not None:
            pst, e, w = prev[st]
            trail.append((e, w))
            st = pst
        trail.reverse()
        triples = np.array([k_map[e, w] for e, w in trail], np.int64)
        paths.append(FlowPath(f, triples, float(p.coflow.size[f]),
                              int(trail[0][1])))
        k_map[es, ws] = -1            # reset scratch for the next flow
    return RoutingIndex(kf, ke, kw, 0, 0), paths


def _pack(p: ScheduleProblem, idx, paths, order_rule: str) -> np.ndarray:
    """Slot-by-slot packing with a per-rule rate policy."""
    F, E, W, T = p.shape_x
    D = p.topo.slot_duration
    slot_cap = p.slot_cap_gbits
    srv_lim = np.where(p.is_server, p.rho * D, np.inf)
    sw_lim = np.where(p.is_switch & np.isfinite(p.sigma), p.sigma * D, np.inf)
    kf, ke, kw = idx.kf, idx.ke, idx.kw
    remaining = p.coflow.size.astype(float).copy()
    x = np.zeros((F, E, W, T))

    def bottleneck(pp):
        return remaining[pp.flow] / min(
            float(p.topo.cap[ke[k], kw[k]]) for k in pp.triples)

    for t in range(T):
        if remaining.max(initial=0.0) <= 1e-9:
            break
        used_ew = np.zeros((E, W))
        egress = np.zeros(p.topo.n_vertices)
        ingress = np.zeros(p.topo.n_vertices)
        active = [pp for pp in paths if remaining[pp.flow] > 1e-9]
        if order_rule == "fifo":
            active.sort(key=lambda pp: pp.flow)
        elif order_rule == "sebf":
            active.sort(key=bottleneck)
        rounds = 1 if order_rule != "fair" else 8
        for rnd in range(rounds):
            for pp in active:
                if remaining[pp.flow] <= 1e-9:
                    continue
                want = remaining[pp.flow]
                if order_rule == "fair":
                    want = min(want, p.coflow.size[pp.flow] / rounds + 1e-9)
                ks = pp.triples
                slack = np.min(np.concatenate([
                    slot_cap[ke[ks], kw[ks]] - used_ew[ke[ks], kw[ks]],
                    srv_lim[p.e_src[ke[ks]]] - egress[p.e_src[ke[ks]]],
                    sw_lim[p.e_dst[ke[ks]]] - ingress[p.e_dst[ke[ks]]]]))
                # PON3 eq. 47: if another wavelength already TXes from this
                # server this slot, skip (wait for a later slot)
                if p.topo.one_wavelength_tx and p.topo.awgr_in_ports:
                    i = int(p.e_src[ke[ks[0]]])
                    if p.is_server[i]:
                        awgr = np.isin(p.e_dst, p.topo.awgr_in_ports)
                        sel = awgr[ke] & (p.e_src[ke] == i)
                        w_used = np.flatnonzero(
                            used_ew[ke[sel], kw[sel]].reshape(-1) > 1e-9)
                        ws_used = set(kw[sel][w_used].tolist())
                        if ws_used and int(kw[ks[0]]) not in ws_used:
                            continue
                ship = min(want, max(float(slack), 0.0))
                if ship <= 1e-9:
                    continue
                np.add.at(used_ew, (ke[ks], kw[ks]), ship)
                np.add.at(egress, p.e_src[ke[ks]], ship)
                np.add.at(ingress, p.e_dst[ke[ks]], ship)
                np.add.at(x, (kf[ks], ke[ks], kw[ks], np.full(len(ks), t)),
                          ship)
                remaining[pp.flow] -= ship
    return x


def schedule(p: ScheduleProblem, rule: str) -> np.ndarray:
    """rule: fifo | fair | sebf.  Returns x[f,e,w,t] (score with
    core.timeslot.evaluate)."""
    idx, paths = _shortest_paths(p)
    return _pack(p, idx, paths, rule)
