"""The plain reference: the paper's scheduling model in NumPy, written
apart from the program and sharing none of its code.

Given the benchmark's own inputs (topology arrays, co-flows and the
horizon) it works out again what the program derives from
them (the route admissibility of each flow, the routing LP's rows and
objective) and judges what the program produced:

  * `check_schedule` - a schedule tensor, given as its nonzero entries,
    against eqs. (25)-(28), (30), (46)-(47) family by family, with its
    exact energy (eqs. 19-22) and completion time (eqs. 39-45);
  * `lp_check` - the program's LP solution against this module's own
    routing LP: the worst violation of any row or bound, its objective,
    and the LP's size (n, m, nnz) for the kernel's byte count.

Units: Gbits, Gbps, seconds, Joules."""
from __future__ import annotations

import dataclasses

import numpy as np

TOL = 1e-6            # a link or device counts as used above this (Gbits)


@dataclasses.dataclass
class Fabric:
    """A topology as arrays: vertices with their kind and power, directed
    edges with per-wavelength capacity (Gbps), slot duration (s)."""

    edges: np.ndarray          # (E, 2) int
    cap: np.ndarray            # (E, W) Gbps
    kind: np.ndarray           # (V,) "server" | "switch" | "passive"
    p_max: np.ndarray          # (V,) W
    eps: np.ndarray            # (V,) W/Gbps
    sigma: np.ndarray          # (V,) Gbps ingress limit, inf = none
    slot_duration: float
    server_relay: bool
    one_wavelength_tx: bool
    awgr_in: np.ndarray        # vertex ids of AWGR ingress ports

    @classmethod
    def from_arrays(cls, t: dict) -> "Fabric":
        return cls(edges=np.asarray(t["edges"], dtype=np.int64),
                   cap=np.asarray(t["cap"], dtype=np.float64),
                   kind=np.asarray(t["kinds"]),
                   p_max=np.asarray(t["p_max"], dtype=np.float64),
                   eps=np.asarray(t["eps"], dtype=np.float64),
                   sigma=np.asarray(t["sigma"], dtype=np.float64),
                   slot_duration=float(t["slot_duration"]),
                   server_relay=bool(t["server_relay"]),
                   one_wavelength_tx=bool(t["one_wavelength_tx"]),
                   awgr_in=np.asarray(t["awgr_in"], dtype=np.int64))

    @property
    def V(self) -> int:
        return len(self.kind)

    @property
    def E(self) -> int:
        return len(self.edges)

    @property
    def W(self) -> int:
        return self.cap.shape[1]

    @property
    def u(self) -> np.ndarray:
        return self.edges[:, 0]

    @property
    def v(self) -> np.ndarray:
        return self.edges[:, 1]

    @property
    def is_server(self) -> np.ndarray:
        return self.kind == "server"

    @property
    def is_switch(self) -> np.ndarray:
        return self.kind == "switch"

    @property
    def passive(self) -> np.ndarray:
        return self.kind == "passive"


def hops(fab: Fabric, starts: np.ndarray, reverse: bool = False
         ) -> np.ndarray:
    """(len(starts), V) hop counts from each start (to it, if reverse)
    over edges with any capacity; inf where unreachable."""
    alive = fab.cap.sum(axis=1) > 0.0
    a, b = (fab.v, fab.u) if reverse else (fab.u, fab.v)
    a, b = a[alive], b[alive]
    S = len(starts)
    dist = np.full((S, fab.V), np.inf)
    frontier = np.zeros((S, fab.V), dtype=bool)
    frontier[np.arange(S), starts] = True
    dist[frontier] = 0
    d = 0
    while frontier.any():
        d += 1
        nxt = np.zeros_like(frontier)
        rows, cols = np.nonzero(frontier[:, a])
        nxt[rows, b[cols]] = True
        nxt &= np.isinf(dist)
        dist[nxt] = d
        frontier = nxt
    return dist


def admissible(fab: Fabric, src: np.ndarray, dst: np.ndarray,
               path_slack: int | None) -> np.ndarray:
    """(F, E) bool: edges flow f may use.  Never into its source or out
    of its destination; where servers do not relay (eq. 46) no edge out
    of a server but the source's and none into one but the
    destination's; with `path_slack`, only edges on some src->dst walk
    at most that many hops longer than the shortest."""
    u, v = fab.u, fab.v
    ok = (v[None, :] != src[:, None]) & (u[None, :] != dst[:, None])
    if not fab.server_relay:
        srv = fab.is_server
        ok &= ~(srv[u][None, :] & (u[None, :] != src[:, None]))
        ok &= ~(srv[v][None, :] & (v[None, :] != dst[:, None]))
    if path_slack is not None and len(src):
        us, si = np.unique(src, return_inverse=True)
        ud, di = np.unique(dst, return_inverse=True)
        from_src = hops(fab, us)[si]                 # (F, V)
        to_dst = hops(fab, ud, reverse=True)[di]     # (F, V)
        shortest = from_src[np.arange(len(src)), dst]
        through = from_src[:, u] + 1 + to_dst[:, v]
        ok &= through <= (shortest + path_slack)[:, None]
    return ok


def dense_to_entries(x: np.ndarray) -> tuple:
    """A dense (F, E, W, T) schedule as its nonzero entries:
    (f, e, w, t, value) and the shape."""
    flat = np.flatnonzero(x)
    f, e, w, t = np.unravel_index(flat, x.shape)
    return (f.astype(np.int64), e.astype(np.int64), w.astype(np.int64),
            t.astype(np.int64), x.reshape(-1)[flat].astype(np.float64),
            x.shape)


def check_schedule(fab: Fabric, src, dst, size, mask, entries, *,
                   rho: float) -> dict:
    """Judge a schedule (its nonzero entries, `dense_to_entries`) of the
    flows (src, dst, size): the worst residual of each constraint family
    in Gbits, and the exact energy (J) and completion time (s)."""
    f, e, w, t, x, shape = entries
    F, E, W, T = shape
    D = fab.slot_duration
    V = fab.V
    u, v = fab.u[e], fab.v[e]
    res = {"negative": float(np.maximum(-x, 0.0).max(initial=0.0))}
    psi = np.bincount((e * W + w) * T + t, weights=x,
                      minlength=E * W * T).reshape(E, W, T)
    res["capacity"] = float((psi - fab.cap[:, :, None] * D).max(initial=0.0))
    link = psi.sum(axis=1)                                      # (E, T)
    egress = np.zeros((V, T))
    np.add.at(egress, fab.u, link)
    res["egress"] = float((egress[fab.is_server] - rho * D).max(initial=0.0))
    ingress = np.zeros((V, T))
    np.add.at(ingress, fab.v, link)
    lim = fab.is_switch & np.isfinite(fab.sigma)
    res["ingress"] = float((ingress[lim] - fab.sigma[lim, None] * D)
                           .max(initial=0.0))
    res["admissible"] = float(np.where(mask[f, e], 0.0, x).max(initial=0.0))
    # conservation at every vertex but the flow's ends: per wavelength at
    # passive vertices, summed over wavelengths at the others
    inner_u = (u != src[f]) & (u != dst[f])
    inner_v = (v != src[f]) & (v != dst[f])
    cons = 0.0
    for per_w, sel_u, sel_v in (
            (True, inner_u & fab.passive[u], inner_v & fab.passive[v]),
            (False, inner_u, inner_v)):
        def key(vert, sel):
            k = f[sel] * V + vert[sel]
            k = k * W + w[sel] if per_w else k
            return k * T + t[sel]
        net = _net(key(u, sel_u), key(v, sel_v), x[sel_u], x[sel_v])
        cons = max(cons, float(np.abs(net).max(initial=0.0)))
    res["conservation"] = cons
    served = (np.bincount(f, weights=np.where(u == src[f], x, 0.0),
                          minlength=F)
              - np.bincount(f, weights=np.where(v == src[f], x, 0.0),
                            minlength=F))
    res["demand"] = float(np.abs(served - size).max(initial=0.0))
    wav = 0.0
    if fab.one_wavelength_tx and len(fab.awgr_in):
        tx = fab.is_server[fab.u] & np.isin(fab.v, fab.awgr_in)   # (E,)
        sel = tx[e]
        per = np.zeros((V, W, T))
        np.add.at(per, (u[sel], w[sel], t[sel]), x[sel])
        used = (per > TOL).sum(axis=1)                            # (V, T)
        wav = float(used.max(initial=0) - 1) if used.size else 0.0
        wav = max(wav, 0.0)
    res["wavelength"] = wav
    # eqs. (19)-(22): a device is on in (wavelength, slot) when it carries
    # traffic; a server's NIC also draws eps per Gbps it carries
    beta = np.zeros((V, W, T))
    np.add.at(beta, fab.u, psi)
    np.add.at(beta, fab.v, psi)
    energy = D * float(((beta > TOL) * fab.p_max[:, None, None]).sum())
    energy += D * float((fab.eps[:, None, None] * beta
                         * fab.is_server[:, None, None]).sum())
    # eqs. (39)-(45): the last used link's in-slot finish time
    used = psi > TOL
    tx_time = np.where(used, psi / np.maximum(fab.cap[:, :, None], 1e-30),
                       0.0)
    omega = np.where(used, D * np.arange(T)[None, None, :] + tx_time, 0.0)
    return dict(residuals=res, energy_j=energy,
                completion_s=float(omega.max(initial=0.0)))


def _net(keys_out, keys_in, vals_out, vals_in):
    keys = np.concatenate([keys_out, keys_in])
    signed = np.concatenate([vals_out, -vals_in])
    _, inv = np.unique(keys, return_inverse=True)
    return np.bincount(inv, weights=signed)


def lp_size(fab: Fabric, src, dst, size, mask, n_slots: int,
            objective: str, rho: float) -> tuple:
    """(n, m, nnz) of the routing LP that `lp_check` builds."""
    K = int(np.count_nonzero(mask[:, :, None] & (fab.cap > 0.0)[None]))
    n = K + len(src) * fab.W + int(objective == "time")
    out = lp_check(fab, src, dst, size, mask, n_slots, objective, rho,
                   np.zeros(n))
    return out["n"], out["m"], out["nnz"]


def lp_check(fab: Fabric, src, dst, size, mask, n_slots: int, objective: str,
             rho: float, x: np.ndarray, y: np.ndarray | None = None,
             row_keys: list | None = None) -> dict:
    """The routing LP of the flows over the horizon, built here, and a
    candidate solution `x` of it judged against every row and bound.

    Columns: one volume (Gbits over the horizon) for each admissible
    (flow, edge, wavelength) triple in (f, e, w) order, one injection a
    (flow, wavelength), and for "time" the completion bound theta (s).
    Rows: conservation of each flow at each vertex it touches (its
    destination's row is implied; per wavelength at passive vertices),
    demand (the injections of a flow sum to its size), each (edge,
    wavelength)'s capacity, each server's egress rate and each switch's
    ingress rate over the horizon (or, for "time", over theta).  The
    energy objective prices a Gbit by its NIC draw and each endpoint's
    power over its incident capacity; "time" minimises theta.

    Returns n, m, nnz, the worst violation in Gbits ("residual", rows and
    box), and the objective at x ("value": J or s).  Given duals `y` of
    the max-normalised LP (the objective over max|c|; y >= 0 on
    inequality rows, rows named by `row_keys` as ("c", f, vertex,
    wavelength or -1), ("d", f), ("ew", e, w), ("srv", u), ("sw", v)),
    also "bound": the lower bound on the LP's optimum that weak duality
    gives for any such y, -q.y + sum_j xmax_j min(0, (c + K^T y)_j)."""
    F, E, W = len(src), fab.E, fab.W
    H = n_slots * fab.slot_duration
    kf, ke, kw = np.nonzero(mask[:, :, None] & (fab.cap > 0.0)[None, :, :])
    K = len(kf)
    theta = objective == "time"
    n = K + F * W + int(theta)
    out = dict(n=n, m=0, nnz=0, residual=np.inf, value=np.nan)
    if x is None or len(x) != n:
        out["size_mismatch"] = None if x is None else len(x)
        return out
    x = np.asarray(x, dtype=np.float64)
    xk, inj = x[:K], x[K:K + F * W].reshape(F, W)
    th = x[-1] if theta else 0.0
    u, v = fab.u[ke], fab.v[ke]
    total = float(size.sum())
    # conservation rows, keyed (f, vertex, wavelength or -1)
    stride = W + 1

    def key(ff, vert, ww):
        return (ff * fab.V + vert) * stride + np.where(
            fab.passive[vert], ww, -1) + 1

    at_v = v != dst[kf]
    fi, wi = np.repeat(np.arange(F), W), np.tile(np.arange(W), F)
    keys = np.concatenate([key(kf, u, kw), key(kf[at_v], v[at_v], kw[at_v]),
                           key(fi, src[fi], wi)])
    vals = np.concatenate([xk, -xk[at_v], -inj.reshape(-1)])
    uk, inv = np.unique(keys, return_inverse=True)
    cons = np.bincount(inv, weights=vals, minlength=len(uk))
    worst = float(np.abs(cons).max(initial=0.0))
    worst = max(worst, float(np.abs(inj.sum(axis=1) - size).max(initial=0.0)))
    # capacity rows of (edge, wavelength), egress and ingress rates
    scale = th if theta else H
    ew, inv = np.unique(ke * W + kw, return_inverse=True)
    load = np.bincount(inv, weights=xk, minlength=len(ew))
    worst = max(worst, float((load - fab.cap[ew // W, ew % W] * scale)
                             .max(initial=0.0)))
    srv_k = fab.is_server[u]
    srv, inv = np.unique(u[srv_k], return_inverse=True)
    worst = max(worst, float((np.bincount(inv, weights=xk[srv_k],
                                          minlength=len(srv)) - rho * scale)
                             .max(initial=0.0)))
    sw_k = fab.is_switch[v] & np.isfinite(fab.sigma[v])
    sw, inv = np.unique(v[sw_k], return_inverse=True)
    worst = max(worst, float((np.bincount(inv, weights=xk[sw_k],
                                          minlength=len(sw))
                              - fab.sigma[sw] * scale).max(initial=0.0)))
    # the box
    xmax = np.concatenate([np.minimum(fab.cap[ke, kw] * H, total),
                           np.repeat(size, W)] + ([[H]] if theta else []))
    worst = max(worst, float(np.maximum(-x, 0.0).max(initial=0.0)),
                float((x - xmax).max(initial=0.0)))
    n_ub = len(ew) + len(srv) + len(sw)
    out.update(m=len(uk) + F + n_ub,
               nnz=(K + int(at_v.sum()) + 2 * F * W + K + int(srv_k.sum())
                    + int(sw_k.sum()) + (n_ub if theta else 0)),
               residual=worst)
    if theta:
        c = np.zeros(n)
        c[:K] = 1e-6 / max(total, 1e-9)
        c[-1] = 1.0
        out["value"] = float(th)
    else:
        inc = np.zeros(fab.V)
        np.add.at(inc, fab.u, fab.cap.sum(axis=1))
        np.add.at(inc, fab.v, fab.cap.sum(axis=1))
        per_gbit = np.where(fab.p_max > 0,
                            fab.p_max / np.maximum(inc, 1e-9), 0.0)
        nic = np.where(fab.is_server, fab.eps, 0.0)
        c = np.zeros(n)
        c[:K] = nic[u] + nic[v] + per_gbit[u] + per_gbit[v] + 1e-6
        out["value"] = float(c[:K] @ xk)
    if y is None or row_keys is None:
        return out
    # the duals of this LP's rows, found by name among the program's
    where = {k: i for i, k in enumerate(row_keys)}
    y = np.asarray(y, dtype=np.float64)

    def dual(keys, ineq=False):
        d = np.array([y[where[k]] if k in where else 0.0 for k in keys])
        return np.maximum(d, 0.0) if ineq else d

    w_eff = uk % stride - 1
    rest = uk // stride
    y_c = dual([("c", int(a), int(b), int(cw)) for a, b, cw in
                zip(rest // fab.V, rest % fab.V, w_eff)])
    y_d = dual([("d", f) for f in range(F)])
    y_ew = dual([("ew", int(e // W), int(e % W)) for e in ew], True)
    y_srv = dual([("srv", int(a)) for a in srv], True)
    y_sw = dual([("sw", int(a)) for a in sw], True)
    cons_row = dict(zip(uk.tolist(), range(len(uk))))
    kty = np.zeros(n)
    ku = np.array([cons_row[k] for k in key(kf, u, kw).tolist()],
                  dtype=np.int64)
    kty[:K] += y_c[ku]
    kv = np.array([cons_row[k] for k in key(kf[at_v], v[at_v],
                                            kw[at_v]).tolist()],
                  dtype=np.int64)
    kty[:K][at_v] -= y_c[kv]
    kty[:K] += y_ew[np.searchsorted(ew, ke * W + kw)]
    kty[:K][srv_k] += y_srv[np.searchsorted(srv, u[srv_k])]
    kty[:K][sw_k] += y_sw[np.searchsorted(sw, v[sw_k])]
    ki = np.array([cons_row[k] for k in key(fi, src[fi], wi).tolist()],
                  dtype=np.int64)
    kty[K:K + F * W] = -y_c[ki] + y_d[fi]
    limits = np.concatenate([fab.cap[ew // W, ew % W], np.full(len(srv), rho),
                             fab.sigma[sw]])
    y_ub = np.concatenate([y_ew, y_srv, y_sw])
    if theta:
        kty[-1] = -float(limits @ y_ub)
        q_y = float(size @ y_d)
    else:
        q_y = float(size @ y_d) + float((limits * H) @ y_ub)
    cscale = max(float(np.abs(c).max(initial=0.0)), 1e-12)
    reduced = c / cscale + kty
    out["bound"] = cscale * (-q_y + float(xmax @ np.minimum(reduced, 0.0)))
    return out
