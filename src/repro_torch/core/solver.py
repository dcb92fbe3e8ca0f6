"""Fast-path solver: PDHG routing LP + slot packing + exact re-scoring.

The port of the reference `repro.core.solver` single-instance path:

  1. a *routing LP* over (flow, edge, wavelength) volumes for the whole
     horizon (`build_routing_lp`, numpy, structure-cached);
  2. diagonally-preconditioned PDHG (Chambolle-Pock) over the LP packed
     in blocked ELL (`solve_lp`): on the card every restart rung is one
     call of the hand-written CUDA burst kernel (kernels/csrc/
     pdhg_burst.cu via kernels.ops.pdhg_burst); with device="cpu" the
     same rung runs the kernel's plain PyTorch version;
  3. path decomposition and a *temporal packing* pass that quantizes the
     fractional routing into the paper's discrete slots (numpy);
  4. exact re-evaluation with core.timeslot.evaluate — so reported E and M
     are always true paper-model numbers, never LP estimates.

The batched form (`solve_lp_batch`, `solve_fast_batch`,
`solve_fast_ensemble`) stacks instances block-diagonally and runs each
level of its restart ladder as one adaptive dispatch of the same kernel
(kernels.ops.pdhg_adaptive), freezing each instance as it converges.

The incremental re-solves (`project_warm_start`, `resolve_incremental`,
`solve_fast_warm`, `solve_fast_group` and `solve_fast_ensemble(warm=...)`)
start PDHG from a finished solve's state projected onto a degraded
fabric (core.failures) or the next epoch of an arrival trace
(core.arrivals), through the same kernel.

The port has one PDHG lowering, the reference's blocked-ELL
`backend="pallas"` one, with its iters/tol/restart semantics.  The
reference's COO `backend="xla"` lowering is not ported: it is built on
scatter-adds, which CUDA runs with atomics in no fixed order, and the
solve promises bitwise-repeatable results.

Units follow the paper throughout: flow sizes and shipped volumes in
Gbits, link/egress/ingress rates in Gbps, slot duration and completion
time in seconds, energy in Joules.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time

import numpy as np
import torch

from .. import device as _device
from ..kernels import ops as kops
from ..kernels import pdhg_spmv
from .timeslot import Metrics, ScheduleProblem, evaluate


# ---------------------------------------------------------------------------
# Structured LP + PDHG
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StructuredLP:
    """min c.x  s.t.  K_eq x = b,  K_ub x <= h,  0 <= x <= xmax.

    K is stored in COO; the eq block occupies rows [0, m_eq)."""

    c: np.ndarray
    row: np.ndarray
    col: np.ndarray
    val: np.ndarray
    b: np.ndarray
    h: np.ndarray
    xmax: np.ndarray

    @property
    def n(self) -> int:
        return len(self.c)

    @property
    def m_eq(self) -> int:
        return len(self.b)

    @property
    def m(self) -> int:
        return len(self.b) + len(self.h)


@dataclasses.dataclass
class PDHGResult:
    x: np.ndarray
    primal_residual: float
    duality_gap_rel: float
    iterations: int
    # final dual iterate (rows ordered [equalities; inequalities]) — kept so
    # a later solve can warm-start both sides of the saddle point
    y: np.ndarray | None = None


def _solve_lp_trivial(lp: StructuredLP) -> PDHGResult:
    """Closed-form solve for degenerate LPs (no variables or no rows).

    A zero-flow CoflowSet produces an LP with no constraint rows (and,
    for the energy objective, no variables at all).  The box-constrained
    minimum is then coordinate-wise: x_j = 0 for c_j >= 0 (every real
    objective here is nonnegative), xmax_j otherwise."""
    x = np.where(lp.c < 0.0,
                 np.where(np.isfinite(lp.xmax), lp.xmax, 0.0), 0.0)
    return PDHGResult(x, 0.0, 0.0, 0, y=np.zeros(lp.m))


def _ell_operator_cached(row, col, val, m, n):
    """Blocked-ELL pack with the layout plan cached per sparsity pattern.

    The plan (stable argsort, per-block widths, gather indices) depends
    only on (row, col, m, n); re-solves over an unchanged structure
    refresh the coefficient values in O(nnz) instead of re-packing
    (`ell_fill`).  Keyed by a content digest, so equal patterns hit
    regardless of which problem object produced them; counters land in
    BUILD_STATS.  Lookup, insertion, eviction and the counters hold
    _CACHE_LOCK (see there); the plan itself is built outside it."""
    key = (m, n, len(val),
           hashlib.blake2b(np.ascontiguousarray(row).tobytes()
                           + np.ascontiguousarray(col).tobytes(),
                           digest_size=16).digest())
    with _CACHE_LOCK:
        plan = _ELL_PLAN_CACHE.get(key)
        if plan is not None:
            BUILD_STATS.ell_hits += 1
    if plan is None:
        t0 = time.perf_counter()
        plan = pdhg_spmv.ell_plan(row, col, m, n)
        with _CACHE_LOCK:
            BUILD_STATS.ell_misses += 1
            BUILD_STATS.ell_s += time.perf_counter() - t0
            _cache_put(_ELL_PLAN_CACHE, _ELL_PLAN_CACHE_MAX, key, plan)
    return pdhg_spmv.ell_fill(plan, val)


def _pack_ell(c, row, col, val, b, h, xmax, m_eq, device: torch.device):
    """Pack one (already max-normalized, xmax-clamped) LP for the burst:
    blocked-ELL tables for both SpMV directions plus the storage-padded
    vector arguments, as tensors on `device`.  Padded x-slots carry
    tau=c=xmax=0 and padded y-slots sig=q=0 with ub=True, so they stay
    pinned at zero through any number of iterations.

    tau, sig and q are computed in float64 numpy and only then cast to
    float32, exactly as the reference does."""
    n, m = len(c), len(b) + len(h)
    op = _ell_operator_cached(row, col, val, m, n)
    q = np.concatenate([b, h])
    abs_val = np.abs(val)
    col_sum = np.zeros(n)
    np.add.at(col_sum, col, abs_val)
    row_sum = np.zeros(m)
    np.add.at(row_sum, row, abs_val)
    tau = 1.0 / np.maximum(col_sum, 1e-12)
    sig = 1.0 / np.maximum(row_sum, 1e-12)
    ub = np.arange(m) >= m_eq

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def padn(a):
        return put(np.pad(np.asarray(a, np.float32), (0, op.n_pad - n)))

    def padm(a):
        return put(np.pad(np.asarray(a, np.float32), (0, op.m_pad - m)))

    vecs = (padn(c), padn(tau), padn(xmax), padm(q), padm(sig),
            put(np.pad(ub, (0, op.m_pad - m), constant_values=True)))
    ell = tuple(put(a) for a in (op.rows.idx, op.rows.val,
                                 op.cols.idx, op.cols.val))
    return op, vecs, ell


def _solve_lp_ell(lp: StructuredLP, iters: int, tol: float,
                  max_restarts: int, x0, y0, device: torch.device,
                  precision: str = "fp32") -> PDHGResult:
    """solve_lp's restart ladder with each rung one fused burst."""
    xmax = np.where(np.isfinite(lp.xmax), lp.xmax, 1e12)
    cscale = max(float(np.abs(lp.c).max(initial=0.0)), 1e-12)
    op, vecs, ell = _pack_ell(lp.c / cscale, lp.row, lp.col, lp.val,
                              lp.b, lp.h, xmax, lp.m_eq, device)
    keep_n = torch.zeros(op.n_pad, dtype=torch.bool, device=device)
    keep_m = torch.zeros(op.m_pad, dtype=torch.bool, device=device)
    work = pdhg_spmv.burst_work(op, device)

    def start(v0, n_true, n_pad):
        if v0 is None:
            return torch.zeros(n_pad, dtype=torch.float32, device=device)
        return torch.from_numpy(np.pad(np.asarray(v0, np.float32),
                                       (0, n_pad - n_true))).to(device)

    x = start(x0, lp.n, op.n_pad)
    y = start(y0, lp.m, op.m_pad)
    total_iters = 0
    for attempt in range(max_restarts + 1):
        x, y, worst = kops.pdhg_burst(
            *vecs, keep_n, keep_m, *ell, x, y,
            row_meta=op.rows.meta, col_meta=op.cols.meta, iters=iters,
            precision=precision, **work)
        total_iters += iters
        primal = float(worst.max())           # padded rows contribute 0
        if primal <= tol:
            break
        iters *= 2
    x_np = x.cpu().numpy()[:lp.n].astype(np.float64)
    y_np = y.cpu().numpy()[:lp.m].astype(np.float64)
    obj = float(lp.c @ x_np) / cscale
    gap = abs(obj + float(np.concatenate([lp.b, lp.h]) @ y_np)) \
        / (1.0 + abs(obj))
    return PDHGResult(x_np, primal, gap, total_iters, y=y_np)


PRECISIONS = ("fp32", "bf16")


def _check_scale_opts(shards: int, precision: str) -> None:
    """Validate the reference's scale knobs.  Both precisions are ported
    (bf16 stores the iterates in bfloat16 between iterations, fp32
    arithmetic); the row-sharded operator (shards > 1) is not yet
    (ROADMAP.md, queue 1 item 10)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"have {PRECISIONS}")
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if shards > 1:
        raise NotImplementedError(
            "shards > 1 (row-sharded PDHG) is not ported yet: ROADMAP.md "
            "queue 1 item 10, scale knobs")


def solve_lp(lp: StructuredLP, iters: int = 4000, *,
             tol: float | None = None, max_restarts: int = 3,
             x0: np.ndarray | None = None,
             y0: np.ndarray | None = None,
             shards: int = 1, precision: str = "fp32",
             device: str | torch.device = "cuda") -> PDHGResult:
    """Solve with PDHG; objective is max-normalized (the schedule is re-scored
    exactly afterwards, so only the argmin matters).  If the primal residual
    exceeds `tol`, continue the trajectory with doubled iterations (warm
    restart — prior progress is never discarded), at most `max_restarts`
    times.  `x0`/`y0` seed the primal/dual iterates (numpy, e.g. the
    state of an earlier solve); default is a cold start from zero.

    `precision="bf16"` stores the PDHG iterates in bfloat16 between
    iterations, with fp32 arithmetic and residuals (the kernel's
    pdhg_burst_bf16 entry); `shards` > 1 is not ported yet and raises
    NotImplementedError.

    `device="cuda"` (the default) runs each rung as one burst of the CUDA
    kernel and raises RuntimeError when no card is available;
    `device="cpu"` runs the kernel's plain PyTorch version."""
    dev = _device.resolve(device)
    _check_scale_opts(shards, precision)
    if tol is None:
        tol = 1e-4 * max(float(np.abs(lp.b).max(initial=0.0)), 1.0)
    if lp.n == 0 or lp.m == 0:
        return _solve_lp_trivial(lp)
    return _solve_lp_ell(lp, iters, tol, max_restarts, x0, y0, dev,
                         precision)


# ---------------------------------------------------------------------------
# Routing LP assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RoutingIndex:
    kf: np.ndarray   # (K,) flow of each admissible (f,e,w) triple
    ke: np.ndarray   # (K,) edge
    kw: np.ndarray   # (K,) wavelength
    n_inj: int       # F*W injection variables
    n_theta: int     # 1 for min-time, else 0
    # row identities, used to map dual iterates between structurally related
    # LPs (healthy -> degraded instance, in the reference's
    # project_warm_start).  eq_keys[i]
    # names equality row i, ub_keys[j] names inequality row m_eq + j:
    #   ("c", f, u, w|-1) conservation   ("d", f) demand
    #   ("ew", e, w) link cap            ("srv", u) egress   ("sw", v) ingress
    eq_keys: list | None = None
    ub_keys: list | None = None


def _admissible(p: ScheduleProblem):
    """Admissible (flow, edge, wavelength) triples, lexicographic (f, e, w)
    order — one vectorized nonzero over flow_edge_mask x edge_w_ok (the
    same triples, in the same order, the reference's historical per-flow
    Python loop emitted)."""
    adm = p.flow_edge_mask[:, :, None] & p.edge_w_ok[None, :, :]
    kf, ke, kw = np.nonzero(adm)
    return kf.astype(np.int64), ke.astype(np.int64), kw.astype(np.int64)



def _rank_by_first_use(codes: np.ndarray):
    """Rank the distinct values of `codes` by first appearance.

    Returns (rank_of_each_entry, codes_in_rank_order).  This is the
    vectorized equivalent of the historical row-allocation dicts: a row
    keyed by `codes[i]` gets the id a Python dict populated on first
    touch would have assigned, so the vectorized assembly reproduces the
    loop builder's row numbering exactly."""
    if len(codes) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy()
    uniq, first, inv = np.unique(codes, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[order] = np.arange(len(uniq))
    return rank[inv], uniq[order]


def _ub_block(row0: int, rank: np.ndarray, cols_k: np.ndarray,
              n_theta: int, i_theta: int):
    """COO entries of one inequality-row family (link cap / egress /
    ingress): per entry its row `row0 + rank` and column `cols_k`, with
    — when minimizing time — a theta coupling entry interleaved at each
    row's first occurrence, exactly where the loop builder's lazy
    `ub_row` emitted it.  Returns (rows, cols, vals, theta_positions);
    theta coefficient slots hold 0.0 and are refreshed from the current
    capacity limits by `_fill_lp`."""
    L = len(rank)
    if not n_theta:
        return (row0 + rank, cols_k, np.ones(L),
                np.zeros(0, dtype=np.int64))
    first = np.zeros(L, dtype=bool)
    if L:
        first[np.unique(rank, return_index=True)[1]] = True
    pos_own = np.arange(L, dtype=np.int64) + np.cumsum(first)
    total = L + int(first.sum())
    rows = np.empty(total, dtype=np.int64)
    cols = np.empty(total, dtype=np.int64)
    vals = np.ones(total)
    rows[pos_own] = row0 + rank
    cols[pos_own] = cols_k
    pos_theta = pos_own[first] - 1
    rows[pos_theta] = row0 + rank[first]
    cols[pos_theta] = i_theta
    vals[pos_theta] = 0.0
    return rows, cols, vals, pos_theta


def _device_cost_per_gbit(p: ScheduleProblem) -> np.ndarray:
    """(V,) surrogate device-power cost per Gbit (the energy objective's
    `p_max / incident_capacity` term), memoized on the topology object —
    it depends only on the topology's capacities and device powers, and
    sweeps build hundreds of problems over the same handful of graphs
    (degraded topologies are fresh objects, so they get fresh caches)."""
    t = p.topo
    cached = getattr(t, "_device_cost_cache", None)
    if cached is not None:
        return cached
    out = np.zeros(t.n_vertices)
    for vert in range(t.n_vertices):
        if p.p_max[vert] > 0:
            inc = t.cap[p.e_src == vert].sum() + t.cap[p.e_dst == vert].sum()
            out[vert] = p.p_max[vert] / max(float(inc), 1e-9)
    t._device_cost_cache = out
    return out



@dataclasses.dataclass
class ProblemStructure:
    """Everything about a routing LP that does not depend on capacity,
    demand, or horizon *values*: the admissible triples, the COO
    sparsity pattern with its constant +/-1 coefficients, the row
    identities, and the gather indices `_fill_lp` needs to refresh the
    value-dependent arrays (c, b, h, xmax, theta coefficients) in
    O(nnz).  Cached across solves keyed by `_structure_key` — arrival
    epochs re-solving the same merged co-flow set, brown-out/scaled
    degradations (cap pattern preserved), and horizon-doubling retries
    all reuse one entry and skip the assembly entirely."""

    idx: RoutingIndex
    n: int
    K: int
    n_cons: int               # conservation equality rows
    m_eq: int
    m: int
    n_theta: int
    row: np.ndarray           # COO rows (shared, treat as read-only)
    col: np.ndarray
    val_base: np.ndarray      # constant coefficients; theta slots hold 0
    theta_pos: np.ndarray     # COO positions of theta coefficients
    ew_e: np.ndarray          # per link-cap row (rank order): edge
    ew_w: np.ndarray          # ... and wavelength
    n_srv: int                # server-egress rows
    sw_verts: np.ndarray      # per switch-ingress row: vertex
    objective: str = "energy"  # which c-vector _fill_lp refreshes


@dataclasses.dataclass
class BuildCacheStats:
    """Counters for the problem-construction fast path (structure cache
    + blocked-ELL plan cache).  Read via `build_cache_stats()`, cleared
    via `reset_build_caches()`."""

    structure_hits: int = 0
    structure_misses: int = 0
    structure_s: float = 0.0      # seconds spent building structures
    fill_s: float = 0.0           # seconds refreshing value arrays
    ell_hits: int = 0
    ell_misses: int = 0
    ell_s: float = 0.0            # seconds building blocked-ELL plans

    def snapshot(self) -> "BuildCacheStats":
        return dataclasses.replace(self)


BUILD_STATS = BuildCacheStats()
_STRUCTURE_CACHE: dict = {}
_STRUCTURE_CACHE_MAX = 256
_ELL_PLAN_CACHE: dict = {}
_ELL_PLAN_CACHE_MAX = 256
# The service loop builds the next group's LPs on a worker thread while
# the main thread solves (service.loop.run_service): both read and evict
# these caches and bump BUILD_STATS.  Every such access holds this lock,
# so an eviction never meets another thread's insertion and no counter
# increment is lost.
_CACHE_LOCK = threading.Lock()


def _cache_put(cache: dict, cap: int, key, value) -> None:
    """Insert into a FIFO-evicted cache; the caller holds _CACHE_LOCK."""
    if key not in cache and len(cache) >= cap:
        cache.pop(next(iter(cache)))
    cache[key] = value


def build_cache_stats() -> BuildCacheStats:
    """The live build-path cache counters (see BuildCacheStats)."""
    return BUILD_STATS


def reset_build_caches() -> None:
    """Drop the structure and ELL-plan caches and zero the counters."""
    with _CACHE_LOCK:
        _STRUCTURE_CACHE.clear()
        _ELL_PLAN_CACHE.clear()
        for f in dataclasses.fields(BuildCacheStats):
            setattr(BUILD_STATS, f.name, f.default)


@dataclasses.dataclass
class DispatchStats:
    """Counters for stacked PDHG dispatches (solve_lp_batch).

    A dispatch is keyed by its static shape: the blocked-ELL packer's
    padded grid, the instance count, the chunk schedule and the budget
    (the reference's pallas dispatch tuple).  `shape_hits` counts
    dispatches whose shape this process has dispatched before,
    `shape_misses` first-seen shapes.  Read via `dispatch_stats()`,
    clear via `reset_dispatch_stats()`."""

    dispatches: int = 0
    shape_hits: int = 0
    shape_misses: int = 0

    def snapshot(self) -> "DispatchStats":
        return dataclasses.replace(self)


DISPATCH_STATS = DispatchStats()
_DISPATCH_SHAPES: set = set()


def dispatch_stats() -> DispatchStats:
    """The live stacked-dispatch shape counters (see DispatchStats)."""
    return DISPATCH_STATS


def reset_dispatch_stats() -> None:
    """Forget seen dispatch shapes and zero the counters."""
    _DISPATCH_SHAPES.clear()
    for f in dataclasses.fields(DispatchStats):
        setattr(DISPATCH_STATS, f.name, f.default)


def _note_dispatch(shape: tuple) -> None:
    """Record one stacked dispatch's static shape (see DispatchStats)."""
    DISPATCH_STATS.dispatches += 1
    if shape in _DISPATCH_SHAPES:
        DISPATCH_STATS.shape_hits += 1
    else:
        DISPATCH_STATS.shape_misses += 1
        _DISPATCH_SHAPES.add(shape)


def _structure_key(p: ScheduleProblem, objective: str) -> tuple:
    """Hashable identity of a routing LP's *structure*.

    Two problems share a ProblemStructure iff every array that shapes
    the sparsity pattern matches: the edge list, the admissibility
    masks (flow_edge_mask already folds in endpoints, path_slack and
    degraded reachability; edge_w_ok is the cap > 0 pattern), vertex
    kinds, and which rate limits are finite.  Capacity/demand/horizon
    VALUES are deliberately excluded — they only feed `_fill_lp`."""
    t = p.topo
    hh = hashlib.blake2b(digest_size=16)
    for a in (t.edges, p.edge_w_ok, p.flow_edge_mask, p.coflow.src,
              p.coflow.dst, p.is_server, p.is_switch,
              np.isfinite(p.sigma)):
        hh.update(np.ascontiguousarray(a).tobytes())
    hh.update(b"rho-finite" if np.isfinite(p.rho) else b"rho-inf")
    return (objective, t.n_vertices, t.n_edges, t.n_wavelengths,
            p.coflow.n_flows, hh.hexdigest())


def _build_structure(p: ScheduleProblem, objective: str) -> ProblemStructure:
    """Vectorized assembly of the value-independent LP skeleton.

    Pure index arithmetic — no per-row Python closures, no (f, e, w)
    dict keys.  Row numbering and COO entry order reproduce the loop
    builder (the reference's `_build_routing_lp_loops`) bit-for-bit: rows are ranked by
    first use (`_rank_by_first_use` mirrors the lazy row-allocation
    dicts) and entries are emitted in the same stream order
    (conservation interleaved per triple, injections, demand, then the
    three inequality families with theta couplings at row creation)."""
    F, E, W, _ = p.shape_x
    V = p.topo.n_vertices
    kf, ke, kw = _admissible(p)
    K = len(kf)
    n_inj = F * W
    n_theta = 1 if objective == "time" else 0
    n = K + n_inj + n_theta
    i_theta = n - 1
    passive = ~(p.is_server | p.is_switch)
    src = p.coflow.src.astype(np.int64)
    dst = p.coflow.dst.astype(np.int64)
    u, v = p.e_src[ke], p.e_dst[ke]

    # --- equality rows ----------------------------------------------------
    # conservation rows keyed ("c", f, vertex, w | -1): per-wavelength at
    # passive vertices, wavelength-summed at electronic ones.  The stream
    # is [u-entry, v-entry] per triple (dst rows skipped — implied), then
    # the injection entries; first use allocates the row.
    stride = np.int64(W + 1)
    codes2 = np.empty(2 * K, dtype=np.int64)
    codes2[0::2] = (kf * V + u) * stride + np.where(passive[u], kw, -1) + 1
    codes2[1::2] = (kf * V + v) * stride + np.where(passive[v], kw, -1) + 1
    valid2 = np.empty(2 * K, dtype=bool)
    valid2[0::2] = u != dst[kf]          # never False (masked), keep guard
    valid2[1::2] = v != dst[kf]
    cols2 = np.repeat(np.arange(K, dtype=np.int64), 2)
    vals2 = np.tile(np.array([1.0, -1.0]), K)

    finj = np.repeat(np.arange(F, dtype=np.int64), W)
    winj = np.tile(np.arange(W, dtype=np.int64), F)
    sv = src[finj]
    inj_codes = (finj * V + sv) * stride + np.where(passive[sv], winj, -1) + 1

    stream = np.concatenate([codes2[valid2], inj_codes])
    row_ids, cons_codes = _rank_by_first_use(stream)
    n_cons = len(cons_codes)
    m_eq = n_cons + F

    inj_cols = K + np.arange(n_inj, dtype=np.int64)
    rows_eq = np.concatenate([
        row_ids, np.repeat(n_cons + np.arange(F, dtype=np.int64), W)])
    cols_eq = np.concatenate([cols2[valid2], inj_cols, inj_cols])
    vals_eq = np.concatenate([vals2[valid2], np.full(n_inj, -1.0),
                              np.full(n_inj, 1.0)])

    w_eff = cons_codes % stride - 1
    rest = cons_codes // stride
    eq_keys = [("c", int(f_), int(vt), int(w_))
               for f_, vt, w_ in zip(rest // V, rest % V, w_eff)]
    eq_keys += [("d", f_) for f_ in range(F)]

    # --- inequality rows --------------------------------------------------
    # shared capacity per (e, w)
    ew_rank, ew_uniq = _rank_by_first_use(ke * W + kw)
    n_ew = len(ew_uniq)
    ew_e, ew_w = ew_uniq // W, ew_uniq % W
    rows_ew, cols_ew, vals_ew, theta_ew = _ub_block(
        m_eq, ew_rank, np.arange(K, dtype=np.int64), n_theta, i_theta)

    # server egress rate
    if np.isfinite(p.rho):
        srv_k = np.flatnonzero(p.is_server[u])
        srv_rank, srv_uniq = _rank_by_first_use(u[srv_k])
    else:
        srv_k = np.zeros(0, dtype=np.int64)
        srv_rank, srv_uniq = _rank_by_first_use(srv_k)
    n_srv = len(srv_uniq)
    rows_srv, cols_srv, vals_srv, theta_srv = _ub_block(
        m_eq + n_ew, srv_rank, srv_k, n_theta, i_theta)

    # switch ingress rate
    sw_k = np.flatnonzero(p.is_switch[v] & np.isfinite(p.sigma[v]))
    sw_rank, sw_uniq = _rank_by_first_use(v[sw_k])
    rows_sw, cols_sw, vals_sw, theta_sw = _ub_block(
        m_eq + n_ew + n_srv, sw_rank, sw_k, n_theta, i_theta)

    ub_keys = [("ew", int(e), int(w_)) for e, w_ in zip(ew_e, ew_w)]
    ub_keys += [("srv", int(x)) for x in srv_uniq]
    ub_keys += [("sw", int(x)) for x in sw_uniq]

    row = np.concatenate([rows_eq, rows_ew, rows_srv, rows_sw])
    col = np.concatenate([cols_eq, cols_ew, cols_srv, cols_sw])
    val_base = np.concatenate([vals_eq, vals_ew, vals_srv, vals_sw])
    off_ew = len(rows_eq)
    off_srv = off_ew + len(rows_ew)
    off_sw = off_srv + len(rows_srv)
    theta_pos = np.concatenate([off_ew + theta_ew, off_srv + theta_srv,
                                off_sw + theta_sw])

    idx = RoutingIndex(kf, ke, kw, n_inj, n_theta,
                       eq_keys=eq_keys, ub_keys=ub_keys)
    return ProblemStructure(
        idx=idx, n=n, K=K, n_cons=n_cons, m_eq=m_eq,
        m=m_eq + n_ew + n_srv + len(sw_uniq), n_theta=n_theta,
        row=row, col=col, val_base=val_base, theta_pos=theta_pos,
        ew_e=ew_e, ew_w=ew_w, n_srv=n_srv, sw_verts=sw_uniq,
        objective=objective)


def _fill_lp(st: ProblemStructure, p: ScheduleProblem) -> StructuredLP:
    """Refresh a cached structure's value arrays from the current problem:
    capacities/rates (h, theta coefficients, xmax), demand (b, xmax) and
    the objective vector.  O(nnz) gathers — no Python per-row work."""
    F, E, W, T = p.shape_x
    horizon = T * p.topo.slot_duration
    kf, ke, kw = st.idx.kf, st.idx.ke, st.idx.kw
    K = st.K
    cap = p.topo.cap
    size = p.coflow.size.astype(np.float64)
    total = max(p.coflow.total_gbits, 1e-9)

    limits = np.concatenate([cap[st.ew_e, st.ew_w],
                             np.full(st.n_srv, p.rho),
                             p.sigma[st.sw_verts]])
    if st.n_theta:
        h = np.zeros(len(limits))
        val = st.val_base.copy()
        val[st.theta_pos] = -limits
    else:
        h = limits * horizon
        val = st.val_base          # fully constant; shared, read-only

    b = np.concatenate([np.zeros(st.n_cons), size])

    c = np.zeros(st.n)
    if st.n_theta:
        c[st.n - 1] = 1.0
        c[:K] += 1e-6 / total          # cycle/path-length regularizer
    else:
        # exact NIC J/Gbit + surrogate device-power-per-Gbit terms, same
        # accumulation order as the loop builder (bit-for-bit)
        contrib = _device_cost_per_gbit(p)
        u, v = p.e_src[ke], p.e_dst[ke]
        eps_u = np.where(p.is_server[u], p.eps[u], 0.0)
        eps_v = np.where(p.is_server[v], p.eps[v], 0.0)
        c[:K] = (eps_u + eps_v) + (contrib[u] + contrib[v]) + 1e-6
        if st.objective == "fair" and p.flow_weight is not None:
            # weighted max-min fairness surrogate: a flow's transport is
            # priced inversely to its weight, so higher-weight tenants
            # are served preferentially under contention.  Uniform
            # weights rescale c by a constant, and solve_lp normalizes
            # by max|c| — so "fair" then coincides with "energy".
            c[:K] /= p.flow_weight[kf]

    xmax = np.full(st.n, np.inf)
    xmax[:K] = np.minimum(cap[ke, kw] * horizon, total)
    xmax[K:K + F * W] = np.repeat(size, W)
    if st.n_theta:
        xmax[st.n - 1] = horizon
    return StructuredLP(c=c, row=st.row, col=st.col, val=val,
                        b=b, h=h, xmax=xmax)


def build_routing_lp(p: ScheduleProblem, objective: str, *,
                     cache: bool = True
                     ) -> tuple[StructuredLP, RoutingIndex]:
    """Assemble the routing LP (see docs/SOLVER.md §1 and §8).

    Vectorized fast path: the value-independent skeleton (sparsity
    pattern, row numbering, RoutingIndex) is built once per structure
    and cached across solves keyed by `_structure_key`; only the value
    arrays (c, b, h, xmax, theta coefficients) are refreshed per call.
    `cache=False` rebuilds the skeleton unconditionally (equivalence
    tests; the arrays produced are identical either way).  The returned
    row/col/kf/ke/kw arrays are shared with the cache — treat them as
    read-only."""
    # "fair" shares the energy structure (n_theta = 0) with a per-flow
    # reweighted c vector; see _fill_lp and docs/POLICIES.md
    assert objective in ("energy", "time", "fair")
    key = _structure_key(p, objective) if cache else None
    with _CACHE_LOCK:
        st = _STRUCTURE_CACHE.get(key) if cache else None
        if st is not None:
            BUILD_STATS.structure_hits += 1
    if st is None:
        t0 = time.perf_counter()
        st = _build_structure(p, objective)
        with _CACHE_LOCK:
            BUILD_STATS.structure_misses += 1
            BUILD_STATS.structure_s += time.perf_counter() - t0
            if cache:
                _cache_put(_STRUCTURE_CACHE, _STRUCTURE_CACHE_MAX, key, st)
    t0 = time.perf_counter()
    lp = _fill_lp(st, p)
    with _CACHE_LOCK:
        BUILD_STATS.fill_s += time.perf_counter() - t0
    return lp, st.idx



# ---------------------------------------------------------------------------
# Path decomposition (clean up approximate LP flows)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlowPath:
    """One src->dst path of a flow with an assigned volume share."""

    flow: int
    triples: np.ndarray        # indices into the (kf, ke, kw) triple arrays
    volume: float              # Gbits assigned to this path
    tx_wavelength: int         # wavelength on the first hop (eq. 47 bookkeeping)


def _out_edges(p: ScheduleProblem) -> list[list[int]]:
    """Outgoing-edge adjacency, memoized on the topology object — the
    decomposition/search helpers run once per flow per solve, and sweeps
    build hundreds of problems over the same handful of graphs (degraded
    topologies are fresh objects, so they get fresh caches)."""
    t = p.topo
    cached = getattr(t, "_out_edges_cache", None)
    if cached is not None:
        return cached
    out: list[list[int]] = [[] for _ in range(t.n_vertices)]
    for e in range(t.n_edges):
        out[int(t.edges[e, 0])].append(e)
    t._out_edges_cache = out
    return out


def _route_search(p: ScheduleProblem, out_edges, src: int, dst: int,
                  usable, convert_ok) -> list[tuple[int, int]] | None:
    """DFS over (vertex, arrival wavelength) states; usable(e, w) gates
    which hops may be taken, convert_ok[u] whether vertex u may change
    wavelength (electronic O/E conversion).  Returns [(edge, w), ...] or
    None if dst is unreachable."""
    W = p.topo.n_wavelengths
    e_dst = p.e_dst
    stack = [(src, -1, [])]
    seen = set()
    while stack:
        u, w_in, trail = stack.pop()
        if u == dst:
            return trail
        if (u, w_in) in seen:
            continue
        seen.add((u, w_in))
        convert = (w_in == -1) or convert_ok[u]
        for e in out_edges[u]:
            for w in range(W):
                if not convert and w != w_in:
                    continue
                if usable(e, w):
                    stack.append((int(e_dst[e]), w, trail + [(e, w)]))
    return None


def path_decompose(p: ScheduleProblem, idx: RoutingIndex,
                   vol: np.ndarray) -> list[FlowPath]:
    """Decompose per-flow (edge, wavelength) volumes into src->dst paths.

    PDHG solutions carry O(residual) conservation error and possibly cycles;
    a path decomposition conserves *exactly* (wavelength-continuous at
    passive vertices, free conversion at electronic ones), drops cyclic
    residue, and — crucially for PON3 — tags each path with the wavelength
    its source transmits on, so eq. 47 can be enforced per path."""
    F, E, W, _ = p.shape_x
    passive = ~(p.is_server | p.is_switch)
    kf, ke, kw = idx.kf, idx.ke, idx.kw
    out_edges = _out_edges(p)
    convert_ok = ~passive
    # per-flow triple ranges: kf is sorted by construction (lexicographic
    # (f, e, w) order), so each flow owns one contiguous slice
    bounds = np.searchsorted(kf, np.arange(F + 1))
    # dense per-flow scratch, touched cells reset between flows:
    # k_map[e, w] = global triple index (-1 = inadmissible for this
    # flow), g[e, w] = remaining decomposable volume — precomputed index
    # arrays instead of the historical (f, e, w)-keyed dicts
    k_map = np.full((E, W), -1, dtype=np.int64)
    g = np.zeros((E, W))

    paths: list[FlowPath] = []
    for f in range(F):
        lo, hi = bounds[f], bounds[f + 1]
        es, ws = ke[lo:hi], kw[lo:hi]
        k_map[es, ws] = np.arange(lo, hi)
        vf = vol[lo:hi]
        g[es, ws] = np.where(vf > 1e-9, vf, 0.0)
        src, dst = int(p.coflow.src[f]), int(p.coflow.dst[f])
        budget = float(p.coflow.size[f])
        n_before = len(paths)
        guard = 4 * E * W + 16
        while (budget > 1e-9 and guard > 0
               and g[es, ws].max(initial=0.0) > 1e-9):
            guard -= 1
            path = _route_search(p, out_edges, src, dst,
                                 lambda e, w: g[e, w] > 1e-9, convert_ok)
            if not path:   # no route, or degenerate src == dst (empty trail)
                break
            pe = np.array([e for e, _ in path], dtype=np.int64)
            pw = np.array([w for _, w in path], dtype=np.int64)
            amt = min(budget, float(g[pe, pw].min()))
            np.subtract.at(g, (pe, pw), amt)
            budget -= amt
            paths.append(FlowPath(f, k_map[pe, pw], amt, int(pw[0])))
        if len(paths) > n_before and budget > 1e-9:
            # the LP iterate routed less than the demand (loose tolerance
            # or dropped cyclic residue): rescale this flow's paths so the
            # decomposition conserves per-flow volume exactly.  The common
            # factor leaves temporal_pack's proportional shares unchanged.
            scale = float(p.coflow.size[f]) / (float(p.coflow.size[f])
                                               - budget)
            for fp in paths[n_before:]:
                fp.volume *= scale
        if len(paths) == n_before:
            # no LP volume survived the 1e-9 gate (tiny flows under a loose
            # LP tolerance) — ship the whole demand on any admissible route
            # so temporal_pack never silently drops a flow
            path = _route_search(p, out_edges, src, dst,
                                 lambda e, w: k_map[e, w] >= 0, convert_ok)
            if path:       # empty trail (src == dst) has no tx wavelength
                pe = np.array([e for e, _ in path], dtype=np.int64)
                pw = np.array([w for _, w in path], dtype=np.int64)
                paths.append(FlowPath(f, k_map[pe, pw], budget, int(pw[0])))
        k_map[es, ws] = -1        # reset scratch for the next flow
        g[es, ws] = 0.0
    return paths


# ---------------------------------------------------------------------------
# Temporal packing (fractional routing -> discrete slots)
# ---------------------------------------------------------------------------

def temporal_pack(p: ScheduleProblem, idx: RoutingIndex,
                  x_route: np.ndarray, *,
                  paths: list[FlowPath] | None = None) -> np.ndarray:
    """Quantize routed path volumes into slots, earliest-first water-filling.

    Every decomposed path ships volume v_p <= remaining_p per slot subject
    to link/server/switch caps; for PON3 each source server transmits on a
    single wavelength per slot (eq. 47), chosen greedily as the wavelength
    with the largest remaining demand at that server.  `paths` skips the
    decomposition when the caller already ran path_decompose on x_route."""
    F, E, W, T = p.shape_x
    D = p.topo.slot_duration
    kf, ke, kw = idx.kf, idx.ke, idx.kw
    K = len(kf)
    if paths is None:
        paths = path_decompose(p, idx, np.maximum(x_route[:K], 0.0))
    if not paths:
        return np.zeros((F, E, W, T))
    P = len(paths)
    # path -> triple incidence as flat arrays, with every gather the slot
    # loop needs (edge, wavelength, endpoints, flow) precomputed once —
    # the loop body below runs up to 60 capacity-scaling rounds per slot
    # and must not re-index the triple arrays each time
    pk_path = np.concatenate([np.full(len(pp.triples), i)
                              for i, pp in enumerate(paths)])
    pk_k = np.concatenate([pp.triples for pp in paths])
    pk_e, pk_w, pk_f = ke[pk_k], kw[pk_k], kf[pk_k]
    pk_u, pk_v = p.e_src[pk_e], p.e_dst[pk_e]
    p_flow = np.array([pp.flow for pp in paths])
    p_txw = np.array([pp.tx_wavelength for pp in paths])
    p_src = p.coflow.src[p_flow]
    # ragged per-path views of the same gathers, for the greedy raise
    p_e = [ke[pp.triples] for pp in paths]
    p_w = [kw[pp.triples] for pp in paths]
    p_u = [p.e_src[e_] for e_ in p_e]
    p_v = [p.e_dst[e_] for e_ in p_e]

    # per-flow demand split over its paths, proportional to decomposed volume
    vol_by_flow = np.zeros(F)
    p_vol = np.array([pp.volume for pp in paths])
    np.add.at(vol_by_flow, p_flow, p_vol)
    share = p_vol / np.maximum(vol_by_flow[p_flow], 1e-30)
    remaining = share * p.coflow.size[p_flow]

    # does this path's source hit an AWGR ingress on its first hop?
    eq47 = np.zeros(P, dtype=bool)
    if p.topo.one_wavelength_tx and p.topo.awgr_in_ports:
        awgr_in = np.isin(p.e_dst, p.topo.awgr_in_ports)
        first_k = np.array([pp.triples[0] for pp in paths])
        eq47 = awgr_in[ke[first_k]]

    slot_cap = p.slot_cap_gbits                                   # (E, W)
    x = np.zeros((F, E, W, T))
    srv_lim = np.where(p.is_server, p.rho * D, np.inf)
    sw_lim = np.where(p.is_switch & np.isfinite(p.sigma), p.sigma * D, np.inf)

    release = (p.release_slot[p_flow] if p.release_slot is not None
               else np.zeros(P, dtype=int))
    for t in range(T):
        if remaining.max(initial=0.0) <= 1e-9:
            break
        active = (remaining > 1e-9) & (release <= t)
        if not active.any():
            continue
        if eq47.any():
            for i in np.unique(p_src[eq47]):
                sel = eq47 & (p_src == i) & active
                if not sel.any():
                    continue
                w_demand = np.zeros(W)
                np.add.at(w_demand, p_txw[sel], remaining[sel])
                w_star = int(np.argmax(w_demand))
                active &= ~(eq47 & (p_src == i) & (p_txw != w_star))

        v = np.where(active, remaining, 0.0)
        for _ in range(60):
            vk = v[pk_path]                                       # volume per hop
            used_ew = np.zeros((E, W))
            np.add.at(used_ew, (pk_e, pk_w), vk)
            with np.errstate(divide="ignore", invalid="ignore"):
                over = np.where(used_ew > slot_cap,
                                slot_cap / np.maximum(used_ew, 1e-30), 1.0)
            scale_hop = over[pk_e, pk_w]
            egress = np.zeros(p.topo.n_vertices)
            np.add.at(egress, pk_u, vk)
            with np.errstate(divide="ignore", invalid="ignore"):
                over_v = np.where(egress > srv_lim,
                                  srv_lim / np.maximum(egress, 1e-30), 1.0)
            scale_hop = np.minimum(scale_hop, over_v[pk_u])
            ingress = np.zeros(p.topo.n_vertices)
            np.add.at(ingress, pk_v, vk)
            with np.errstate(divide="ignore", invalid="ignore"):
                over_s = np.where(ingress > sw_lim,
                                  sw_lim / np.maximum(ingress, 1e-30), 1.0)
            scale_hop = np.minimum(scale_hop, over_s[pk_v])
            pscale = np.ones(P)
            np.minimum.at(pscale, pk_path, scale_hop)
            if (pscale > 1.0 - 1e-9).all():
                break
            v = v * np.minimum(pscale, 1.0)

        # greedy raise: refill slack for paths the proportional scaling
        # under-served (largest remaining first)
        vk = v[pk_path]
        used_ew = np.zeros((E, W))
        np.add.at(used_ew, (pk_e, pk_w), vk)
        egress = np.zeros(p.topo.n_vertices)
        np.add.at(egress, pk_u, vk)
        ingress = np.zeros(p.topo.n_vertices)
        np.add.at(ingress, pk_v, vk)
        want = np.where(active, remaining - v, 0.0)
        for pi in np.argsort(-want):
            if want[pi] <= 1e-9:
                continue
            slack = np.min(np.concatenate([
                slot_cap[p_e[pi], p_w[pi]] - used_ew[p_e[pi], p_w[pi]],
                srv_lim[p_u[pi]] - egress[p_u[pi]],
                sw_lim[p_v[pi]] - ingress[p_v[pi]]]))
            add = min(float(want[pi]), max(float(slack), 0.0))
            if add <= 1e-9:
                continue
            v[pi] += add
            np.add.at(used_ew, (p_e[pi], p_w[pi]), add)
            np.add.at(egress, p_u[pi], add)
            np.add.at(ingress, p_v[pi], add)

        np.add.at(x[:, :, :, t], (pk_f, pk_e, pk_w), v[pk_path])
        remaining = np.maximum(remaining - v, 0.0)
    return x


@dataclasses.dataclass
class FastPathResult:
    schedule: np.ndarray      # x[f, e, w, t] in Gbits (exact paper tensor)
    metrics: Metrics          # exact core.timeslot.evaluate numbers (J, s)
    lp_lower_bound: float     # theta (min-time) or LP objective (min-energy)
    lp_primal_residual: float
    remaining_gbits: float    # demand the packer could not place in-horizon
    # PDHG terminal state + LP indexing, retained so this solve can seed a
    # warm-started re-solve (solve_lp's x0/y0)
    lp_x: np.ndarray | None = None
    lp_y: np.ndarray | None = None
    index: RoutingIndex | None = None
    paths: list[FlowPath] | None = None
    iterations: int = 0       # PDHG iterations actually spent
    lp_cscale: float = 1.0    # max|c| the LP was normalized by (duals scale)
    # True iff PDHG started from a projected warm state (set by
    # solve_fast_warm and solve_fast_group)
    warm_started: bool = False
    # core.verify.Certificate when the producer attached one (the policy
    # zoo always does); the LP fast path leaves it None and callers
    # certify on demand via core.verify.check_schedule
    certificate: object | None = None


def _assemble_fast_result(p: ScheduleProblem, lp: StructuredLP,
                          idx: RoutingIndex, res: PDHGResult
                          ) -> FastPathResult:
    """Pack the LP routing into slots and re-score it with the exact paper
    model — one function for every fast path, so their reported numbers
    can never drift apart."""
    K = len(idx.kf)
    paths = path_decompose(p, idx, np.maximum(res.x[:K], 0.0))
    x = temporal_pack(p, idx, res.x, paths=paths)
    m = evaluate(p, x)
    lb = float(res.x[-1]) if idx.n_theta else float(lp.c @ res.x)
    return FastPathResult(schedule=x, metrics=m, lp_lower_bound=lb,
                          lp_primal_residual=res.primal_residual,
                          remaining_gbits=float(np.maximum(
                              p.coflow.size - m.served, 0.0).sum()),
                          lp_x=res.x, lp_y=res.y, index=idx, paths=paths,
                          iterations=res.iterations,
                          lp_cscale=max(float(np.abs(lp.c).max(initial=0.0)),
                                        1e-12))


def solve_fast(p: ScheduleProblem, objective: str = "energy", *,
               iters: int = 4000, tol: float | None = None,
               shards: int = 1, precision: str = "fp32",
               x0: np.ndarray | None = None, y0: np.ndarray | None = None,
               device: str | torch.device = "cuda") -> FastPathResult:
    """Single-instance fast path: routing LP -> PDHG -> slot packing ->
    exact re-scoring.

    Args:
      p: the problem; flow sizes in Gbits, capacities/rates in Gbps.
      objective: "energy" (minimize Joules, eq. 22 surrogate), "time"
        (minimize the continuous completion-time bound theta), or "fair"
        (energy re-priced by 1/flow_weight).
      iters: PDHG iterations per restart rung (doubled on each restart,
        up to solve_lp's max_restarts).
      tol: primal-residual target in Gbits; default 1e-4 * max demand.
      shards, precision: the reference's scale knobs.  precision "fp32"
        or "bf16" (bf16 iterate storage, fp32 arithmetic); shards > 1
        is not ported yet and raises NotImplementedError.
      x0, y0: numpy PDHG warm start (see solve_lp).
      device: "cuda" (default; raises when no card is available) or
        "cpu" (the kernel's plain PyTorch version).

    Returns a FastPathResult whose `metrics` are always the exact paper
    equations evaluated on the packed schedule — never LP estimates.

    Determinism: there is no RNG anywhere in the fast path, and the CUDA
    kernel sums every row in a fixed order with no atomics, so repeated
    calls with equal inputs on one device return identical schedules.
    The card and the CPU agree to fp tolerance (~1e-4 relative on
    metrics), not bitwise."""
    dev = _device.resolve(device)
    lp, idx = build_routing_lp(p, objective)
    res = solve_lp(lp, iters=iters, tol=tol, x0=x0, y0=y0, shards=shards,
                   precision=precision, device=dev)
    return _assemble_fast_result(p, lp, idx, res)


# ---------------------------------------------------------------------------
# Batched solve (instance axis): block-diagonal stacking, adaptive freezing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockStackedLP:
    """`B` StructuredLPs joined block-diagonally into one big LP.

    PDHG with diagonal preconditioning decouples exactly over the blocks
    — every coordinate's step size and update depends only on its own
    block — so solving the stacked LP reproduces each instance's own
    trajectory.  All equality rows (across instances) come first so the
    burst's single m_eq split still applies."""

    lp: StructuredLP               # the stacked LP
    n_off: np.ndarray              # (B+1,) variable offsets
    eq_off: np.ndarray             # (B+1,) equality-row offsets
    ub_off: np.ndarray             # (B+1,) inequality-row offsets


def block_stack(lps: list[StructuredLP]) -> BlockStackedLP:
    n_off = np.cumsum([0] + [lp.n for lp in lps])
    eq_off = np.cumsum([0] + [lp.m_eq for lp in lps])
    ub_off = np.cumsum([0] + [lp.m - lp.m_eq for lp in lps])
    m_eq = int(eq_off[-1])
    rows, cols, vals, cs, xmaxs = [], [], [], [], []
    for i, lp in enumerate(lps):
        is_eq = lp.row < lp.m_eq
        rows.append(np.where(is_eq, lp.row + eq_off[i],
                             m_eq + ub_off[i] + (lp.row - lp.m_eq)))
        cols.append(lp.col + n_off[i])
        vals.append(lp.val)
        cscale = max(float(np.abs(lp.c).max(initial=0.0)), 1e-12)
        cs.append(lp.c / cscale)
        xmaxs.append(np.where(np.isfinite(lp.xmax), lp.xmax, 1e12))
    stacked = StructuredLP(
        c=np.concatenate(cs), row=np.concatenate(rows),
        col=np.concatenate(cols), val=np.concatenate(vals),
        b=np.concatenate([lp.b for lp in lps]),
        h=np.concatenate([lp.h for lp in lps]),
        xmax=np.concatenate(xmaxs))
    return BlockStackedLP(stacked, n_off, eq_off, ub_off)


def _per_instance_residuals(bs: BlockStackedLP, x: np.ndarray) -> np.ndarray:
    """Exact per-instance primal residuals of the stacked iterate."""
    lp = bs.lp
    r = np.zeros(lp.m)
    np.add.at(r, lp.row, lp.val * x[lp.col])
    r -= np.concatenate([lp.b, lp.h])
    B = len(bs.n_off) - 1
    m_eq = lp.m_eq
    out = np.zeros(B)
    for i in range(B):
        eq = r[bs.eq_off[i]:bs.eq_off[i + 1]]
        ub = r[m_eq + bs.ub_off[i]:m_eq + bs.ub_off[i + 1]]
        out[i] = max(np.abs(eq).max(initial=0.0),
                     np.maximum(ub, 0.0).max(initial=0.0))
    return out


def solve_lp_batch(lps: list[StructuredLP], iters: int = 4000, *,
                   tol: float | None = None, max_restarts: int = 3,
                   adaptive: bool = True, chunk: int = 500,
                   warm_starts: list[tuple[np.ndarray, np.ndarray]] | None
                   = None, bucket: bool = True, shards: int = 1,
                   precision: str = "fp32",
                   device: str | torch.device = "cuda") -> list[PDHGResult]:
    """Solve a batch of LPs in stacked PDHG dispatches: the reference's
    solve_lp_batch with backend="pallas", every dispatch one block-
    diagonal stack (BlockStackedLP) packed in blocked ELL.

    Both modes run an escalation ladder that re-stacks only the
    still-unconverged instances each level, so every instance follows
    exactly the trajectory of its solo solve.  With `adaptive=True`
    (default) a level is kernels.ops.pdhg_adaptive: `chunk`-iteration
    bursts, per-instance residuals checked on the device after each, and
    converged instances frozen, so a level stops within `chunk`
    iterations of its last straggler.  With `adaptive=False` a level is
    one kernels.ops.pdhg_burst of the level's budget, the solve_lp
    warm-restart ladder (iters, then doubled).  Both cap at the
    ladder's total budget (sum of iters * 2**a for a <= max_restarts).
    The decision to re-stack an instance uses the exact float64
    residuals of its fp32 iterate (_per_instance_residuals).

    `warm_starts[i] = (x0, y0)` seeds instance i's primal/dual iterates
    (shapes (lps[i].n,) and (lps[i].m,), y0 ordered [eq; ub]).
    Degenerate members (no rows or no variables) solve in closed form
    and never enter a dispatch.

    `bucket` is accepted and has no effect, as in the reference's pallas
    branch: the blocked-ELL packer's padded grid is the dispatch shape.
    `precision="bf16"` stores the iterates in bfloat16 between
    iterations; `shards` > 1 is not ported yet and raises
    NotImplementedError.  `device` as in solve_lp: "cuda" (default,
    the CUDA kernel; raises without a card) or "cpu" (its plain
    version).

    Determinism: no RNG and fixed-order sums in the kernel, so results
    repeat bitwise on one device for fixed inputs."""
    dev = _device.resolve(device)
    _check_scale_opts(shards, precision)
    B = len(lps)
    all_tols = np.array([tol if tol is not None
                         else 1e-4 * max(float(np.abs(lp.b).max(initial=0.0)),
                                         1.0)
                         for lp in lps])

    def _run_ell(g: StructuredLP, bs: BlockStackedLP, x0, y0,
                 sub: list[int], budget: int):
        """One stacked dispatch through the burst kernel: pack the
        stacked LP into blocked ELL, then run the adaptive driver (or
        one fixed burst)."""
        op, vecs, ell = _pack_ell(g.c, g.row, g.col, g.val, g.b, g.h,
                                  g.xmax, g.m_eq, dev)
        # the blocked-ELL packer's padded grid is the dispatch shape
        _note_dispatch(("pallas", adaptive, chunk if adaptive else 0,
                        budget, op.n_pad, op.m_pad, len(sub)))
        work = pdhg_spmv.burst_work(op, dev)
        x0p = torch.from_numpy(np.pad(np.asarray(x0, np.float32),
                                      (0, op.n_pad - g.n))).to(dev)
        y0p = torch.from_numpy(np.pad(np.asarray(y0, np.float32),
                                      (0, op.m_pad - g.m))).to(dev)
        if adaptive:
            # storage coordinate -> instance id; padded slots go to the
            # dump segment len(sub) (always treated as frozen/converged)
            inst_n = np.full(op.n_pad, len(sub), np.int64)
            inst_n[:g.n] = np.repeat(np.arange(len(sub)), np.diff(bs.n_off))
            inst_m = np.full(op.m_pad, len(sub), np.int64)
            inst_m[:g.m] = np.concatenate(
                [np.repeat(np.arange(len(sub)), np.diff(bs.eq_off)),
                 np.repeat(np.arange(len(sub)), np.diff(bs.ub_off))])
            x, y, _, used_chunks = kops.pdhg_adaptive(
                *vecs, *ell, x0p, y0p,
                torch.from_numpy(all_tols[sub].astype(np.float32)).to(dev),
                torch.from_numpy(inst_n).to(dev),
                torch.from_numpy(inst_m).to(dev),
                num_inst=len(sub), row_meta=op.rows.meta,
                col_meta=op.cols.meta, chunk=chunk,
                max_chunks=budget // chunk, precision=precision, **work)
            used = used_chunks.cpu().numpy().astype(np.int64) * chunk
        else:
            x, y, _ = kops.pdhg_burst(
                *vecs, torch.zeros(op.n_pad, dtype=torch.bool, device=dev),
                torch.zeros(op.m_pad, dtype=torch.bool, device=dev),
                *ell, x0p, y0p, row_meta=op.rows.meta,
                col_meta=op.cols.meta, iters=budget, precision=precision,
                **work)
            used = np.full(len(sub), budget)
        return x.cpu().numpy()[:g.n], y.cpu().numpy()[:g.m], used

    def _run(sub: list[int], states, budget: int):
        """One stacked dispatch over the instances in `sub`; returns
        (x, y, residuals, iterations) split per instance."""
        bs = block_stack([lps[i] for i in sub])
        g = bs.lp
        if states is None:
            x0, y0 = np.zeros(g.n, np.float32), np.zeros(g.m, np.float32)
        else:
            x0 = np.concatenate([states[i][0] for i in sub])
            y0 = np.concatenate(
                [states[i][1][:lps[i].m_eq] for i in sub]
                + [states[i][1][lps[i].m_eq:] for i in sub])
        x_np, y_np, used = _run_ell(g, bs, x0, y0, sub, budget)
        res = _per_instance_residuals(bs, x_np)
        outs = {}
        for j, i in enumerate(sub):
            xi = x_np[bs.n_off[j]:bs.n_off[j + 1]]
            yi = np.concatenate(
                [y_np[bs.eq_off[j]:bs.eq_off[j + 1]],
                 y_np[g.m_eq + bs.ub_off[j]:g.m_eq + bs.ub_off[j + 1]]])
            outs[i] = (xi, yi, float(res[j]), int(used[j]))
        return outs

    # escalation ladder with re-stacking: each level runs only the
    # still-unconverged instances (warm-started), so a converged instance
    # stops exactly where its solo solve would and stragglers don't drag
    # the full batch width through their extra iterations.  adaptive=True
    # checks convergence every chunk inside the level and starts from a
    # fraction of `iters`; adaptive=False reproduces the per-instance
    # solve_lp ladder (iters, then doubled, warm-started).  Both cap at
    # the ladder's total budget.
    x_fin = {}
    y_fin = {}
    res_fin = np.zeros(B)
    iters_fin = np.zeros(B, dtype=int)
    states = None
    if warm_starts is not None:
        assert len(warm_starts) == B
        states = {i: (np.asarray(x0, np.float64), np.asarray(y0, np.float64))
                  for i, (x0, y0) in enumerate(warm_starts)}
        for i, (x0, y0) in states.items():
            assert x0.shape == (lps[i].n,) and y0.shape == (lps[i].m,), \
                (i, x0.shape, y0.shape, lps[i].n, lps[i].m)
            x_fin[i], y_fin[i] = x0, y0
    # degenerate members (zero-flow instances: no rows or no variables)
    # solve in closed form and never enter the stacked dispatches
    active = []
    for i in range(B):
        if lps[i].n == 0 or lps[i].m == 0:
            triv = _solve_lp_trivial(lps[i])
            x_fin[i], y_fin[i] = triv.x, triv.y
        else:
            active.append(i)
    total_budget = sum(iters * 2 ** a for a in range(max_restarts + 1))
    budget = max(chunk, iters // 4) if adaptive else iters
    spent = 0
    while active and spent < total_budget:
        budget = min(budget, total_budget - spent)
        if adaptive:
            # whole chunks only, so a level never exceeds its budget and
            # per-instance iteration accounting stays exact
            budget = max(chunk, budget - budget % chunk)
        outs = _run(active, states, budget)
        states = states or {}
        for i, (xi, yi, ri, ki) in outs.items():
            states[i] = (xi, yi)
            x_fin[i], y_fin[i] = xi, yi
            res_fin[i], iters_fin[i] = ri, iters_fin[i] + ki
        active = [i for i in active if res_fin[i] > all_tols[i]]
        spent += budget
        budget *= 2

    out = []
    for i, lp in enumerate(lps):
        xi = x_fin[i]
        obj = float(lp.c @ xi)
        # per-instance gap proxy mirrors solve_lp's (|c.x + q.y| form)
        qi = np.concatenate([lp.b, lp.h])
        cscale = max(float(np.abs(lp.c).max(initial=0.0)), 1e-12)
        objn = obj / cscale
        gap = abs(objn + float(qi @ y_fin[i])) / (1.0 + abs(objn))
        out.append(PDHGResult(xi, float(res_fin[i]), gap, int(iters_fin[i]),
                              y=y_fin[i]))
    return out


def solve_fast_batch(problems: list[ScheduleProblem],
                     objective: str = "energy", *,
                     iters: int = 4000, tol: float | None = None,
                     adaptive: bool = True, bucket: bool = True,
                     shards: int = 1, precision: str = "fp32",
                     device: str | torch.device = "cuda"
                     ) -> list[FastPathResult]:
    """Batched fast path over ScheduleProblems sharing one topology.

    The routing LPs (which differ per instance through task placement and
    flow sizes) are stacked block-diagonally and solved in a few adaptive
    dispatches (solve_lp_batch, chunk 500); slot packing and the exact
    paper-model re-evaluation stay per instance (numpy).

    Units and determinism are as in solve_fast; each element of the
    returned list reports exact paper-model metrics for its instance.
    Instances may differ in capacities — only vertex/edge structure must
    match (ValueError otherwise); for heterogeneous instance lists use
    solve_fast_ensemble, which this call delegates to after the check."""
    if not problems:
        return []
    t0 = problems[0].topo
    for p in problems[1:]:
        t = p.topo
        if t is not t0 and (t.n_vertices != t0.n_vertices
                            or t.n_edges != t0.n_edges
                            or not np.array_equal(t.edges, t0.edges)):
            raise ValueError("solve_fast_batch requires a shared topology "
                             f"structure; got {t0.name} and {t.name}")
    return solve_fast_ensemble(problems, objective, iters=iters, tol=tol,
                               adaptive=adaptive, chunk=500, bucket=bucket,
                               shards=shards, precision=precision,
                               device=device)


def solve_fast_ensemble(problems: list[ScheduleProblem],
                        objective: str = "energy", *,
                        warm: list[FastPathResult] | None = None,
                        iters: int = 4000, tol: float | None = None,
                        adaptive: bool = True, chunk: int | None = None,
                        bucket: bool = True, shards: int = 1,
                        precision: str = "fp32",
                        device: str | torch.device = "cuda"
                        ) -> list[FastPathResult]:
    """Batched fast path over a (possibly heterogeneous) instance list.

    Unlike solve_fast_batch this does not require a shared topology —
    the block-diagonal stacking never did — so a whole failure ensemble
    (one degraded topology per member) solves in the same stacked
    adaptive dispatches as a seed vector.  With `warm[i]` set to the
    healthy result that instance i degrades, every member starts from
    its projected healthy state (project_warm_start) and the adaptive
    driver freezes it within one residual-check chunk of convergence.
    `chunk` defaults to 250 with warm starts and 500 without, as in the
    reference.  `device` as in solve_fast_batch."""
    dev = _device.resolve(device)
    if not problems:
        return []
    built = [build_routing_lp(p, objective) for p in problems]
    lps = [lp for lp, _ in built]
    warm_starts = None
    if warm is not None:
        assert len(warm) == len(problems)
        warm_starts = [project_warm_start(w, p, lp, idx)
                       for w, p, (lp, idx) in zip(warm, problems, built)]
    if chunk is None:
        # warm starts usually converge within a burst or two, so check
        # residuals at a finer grain than the cold default
        chunk = 250 if warm_starts is not None else 500
    results = solve_lp_batch(lps, iters=iters, tol=tol, adaptive=adaptive,
                             chunk=chunk, warm_starts=warm_starts,
                             bucket=bucket, shards=shards,
                             precision=precision, device=dev)
    return [_assemble_fast_result(p, lp, idx, res)
            for p, (lp, idx), res in zip(problems, built, results)]


# ---------------------------------------------------------------------------
# Incremental re-solves (degraded topologies, core.failures; arrival
# epochs, core.arrivals)
# ---------------------------------------------------------------------------

def project_warm_start(warm: FastPathResult, p_dst: ScheduleProblem,
                       lp_dst: StructuredLP, idx_dst: RoutingIndex, *,
                       flow_map: np.ndarray | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Map a finished solve's PDHG state onto a structurally related LP.

    Intended for healthy -> degraded re-solves where `p_dst` keeps the
    source instance's device/edge indexing (core.failures preserves it):

      * the healthy routing is re-used *by path* — each decomposed
        src->dst path whose every (edge, wavelength) hop is still
        admissible keeps its volume; paths crossing a failed link are
        dropped and their volume is re-routed onto any surviving
        admissible route (found by the same wavelength-continuity DFS
        path_decompose uses), so the primal start conserves flow exactly;
      * duals transfer row-by-row through RoutingIndex.eq_keys/ub_keys
        (rows that vanished with their edges are dropped, new rows start
        at zero).

    Returns float64 (x0, y0) with x0 clipped into [0, xmax]; feed them to
    solve_lp or solve_lp_batch(warm_starts=...), which cast them to
    float32 for the burst.  The projection is a heuristic start, not a
    feasible point — PDHG repairs the remaining demand/capacity mismatch,
    which for localized failures takes a small fraction of a cold
    solve's iterations.

    `flow_map` generalizes the projection to LPs whose *flow indexing*
    differs from the source solve's (the rolling-horizon arrival engine,
    core.arrivals, carries residual flows forward under new indices and
    appends newly arrived flows): flow_map[i] is the source-instance
    flow that dst flow i continues, or -1 for a brand-new flow (which
    starts cold).  None keeps the identity mapping.

    A numpy copy of the reference's projection: the same inputs give
    bitwise-equal starts (tests/test_torch_warm.py)."""
    src_idx = warm.index
    if src_idx is None or warm.lp_x is None:
        raise ValueError("warm result lacks PDHG state (lp_x/index); "
                         "it must come from solve_fast/solve_fast_batch")
    F, E, W, _ = p_dst.shape_x
    if flow_map is not None:
        flow_map = np.asarray(flow_map, dtype=np.int64)
        if flow_map.shape != (F,):
            raise ValueError(f"flow_map shape {flow_map.shape} != ({F},)")
    # dst flow of each source flow (identity when flow_map is None)
    dst_of = ({int(s): i for i, s in enumerate(flow_map) if s >= 0}
              if flow_map is not None else None)

    def src_key(key):
        """Translate a dst row identity to the source instance's."""
        if flow_map is not None and key[0] in ("c", "d"):
            fs = int(flow_map[key[1]])
            if fs < 0:
                return None
            return (key[0], fs) + key[2:]
        return key

    K_dst = len(idx_dst.kf)
    key_dst = (idx_dst.kf * E + idx_dst.ke) * W + idx_dst.kw   # sorted

    def dst_pos(f, e, w):
        key = (f * E + e) * W + w
        j = int(np.searchsorted(key_dst, key))
        return j if j < K_dst and key_dst[j] == key else -1

    x0 = np.zeros(lp_dst.n)
    ke_s, kw_s = src_idx.ke, src_idx.kw
    size_dst = p_dst.coflow.size
    lost = np.zeros(F)
    shipped = np.zeros(F)
    for path in warm.paths or []:
        f = (path.flow if dst_of is None else dst_of.get(path.flow, -1))
        if f < 0 or f >= F or size_dst[f] <= 0.0 or path.volume <= 0.0:
            continue
        hops = [(int(ke_s[k]), int(kw_s[k])) for k in path.triples]
        pos = [dst_pos(f, e, w) for e, w in hops]
        vol = min(path.volume, float(size_dst[f]) - shipped[f])
        if vol <= 0.0:
            continue
        if all(j >= 0 for j in pos):
            for j in pos:
                x0[j] += vol
            x0[K_dst + f * W + hops[0][1]] += vol
            shipped[f] += vol
        else:
            lost[f] += vol

    # re-route volume stranded by failed hops onto any surviving route
    out_edges = _out_edges(p_dst)
    convert_ok = p_dst.is_server | p_dst.is_switch
    for f in np.flatnonzero(lost > 0.0):
        f = int(f)
        vol = min(lost[f], float(size_dst[f]) - shipped[f])
        if vol <= 0.0:
            continue
        trail = _route_search(
            p_dst, out_edges, int(p_dst.coflow.src[f]),
            int(p_dst.coflow.dst[f]),
            lambda e, w, f=f: dst_pos(f, e, w) >= 0, convert_ok)
        if not trail:
            continue
        for e, w in trail:
            x0[dst_pos(f, e, w)] += vol
        x0[K_dst + f * W + trail[0][1]] += vol
        shipped[f] += vol

    if idx_dst.n_theta:
        # theta couples every capacity row (sum x <= limit * theta); the
        # healthy theta is stale on a degraded fabric, so lift it to the
        # smallest value that makes the projected routing capacity-feasible
        # — otherwise the warm start dumps residual on every coupled row
        theta = float(warm.lp_x[-1]) if src_idx.n_theta else 0.0
        kx = np.zeros(lp_dst.m)
        np.add.at(kx, lp_dst.row, lp_dst.val * x0[lp_dst.col])
        th = (lp_dst.col == lp_dst.n - 1) & (lp_dst.row >= lp_dst.m_eq)
        if th.any():
            limits = -lp_dst.val[th]
            need = kx[lp_dst.row[th]] / np.maximum(limits, 1e-12)
            theta = max(theta, float(need.max(initial=0.0)))
        x0[-1] = theta
    x0 = np.clip(x0, 0.0, np.where(np.isfinite(lp_dst.xmax),
                                   lp_dst.xmax, 1e12))

    y0 = np.zeros(lp_dst.m)
    if (warm.lp_y is not None and src_idx.eq_keys is not None
            and idx_dst.eq_keys is not None):
        # both LPs are solved with max-normalized objectives (c / cscale);
        # duals of the normalized problems relate by the cscale ratio, so
        # rescale before transplanting (matters when a failure changes the
        # cost vector, e.g. halved capacities double the device-cost terms)
        cscale_dst = max(float(np.abs(lp_dst.c).max(initial=0.0)), 1e-12)
        rescale = warm.lp_cscale / cscale_dst
        m_eq_src = len(src_idx.eq_keys)
        src_eq = {k: i for i, k in enumerate(src_idx.eq_keys)}
        src_ub = {k: i for i, k in enumerate(src_idx.ub_keys)}
        for i, k in enumerate(idx_dst.eq_keys):
            ks = src_key(k)
            j = src_eq.get(ks) if ks is not None else None
            if j is not None:
                y0[i] = warm.lp_y[j] * rescale
        for i, k in enumerate(idx_dst.ub_keys):
            j = src_ub.get(k)          # capacity rows carry no flow index
            if j is not None:
                y0[lp_dst.m_eq + i] = warm.lp_y[m_eq_src + j] * rescale
    return x0, y0


def stranded_volume(warm: FastPathResult, p_dst: ScheduleProblem, *,
                    flow_map: np.ndarray | None = None) -> np.ndarray:
    """(F_dst,) Gbits of `warm`'s decomposed path volume whose hops died.

    A path is *stranded* when any of its (edge, wavelength) hops is no
    longer admissible under `p_dst` (capacity zeroed by a failure, or
    the hop pruned from the flow's edge mask).  This is exactly the
    volume `project_warm_start` drops and re-routes via the surviving
    admissible routes — core.arrivals.run_online reports its sum as
    stranded Gbits re-routed.  `flow_map` has project_warm_start's
    semantics; per-flow totals are clipped to the dst residual demand.
    Returns zeros when the warm result carries no decomposed paths."""
    F = p_dst.coflow.n_flows
    stranded = np.zeros(F)
    if warm.index is None or not warm.paths:
        return stranded
    dst_of = ({int(s): i for i, s in enumerate(np.asarray(flow_map))
               if s >= 0} if flow_map is not None else None)
    ke_s, kw_s = warm.index.ke, warm.index.kw
    for path in warm.paths:
        f = (path.flow if dst_of is None else dst_of.get(path.flow, -1))
        if f < 0 or f >= F or path.volume <= 0.0:
            continue
        dead = any(not (p_dst.edge_w_ok[int(ke_s[k]), int(kw_s[k])]
                        and p_dst.flow_edge_mask[f, int(ke_s[k])])
                   for k in path.triples)
        if dead:
            stranded[f] += path.volume
    return np.minimum(stranded, p_dst.coflow.size)


def resolve_incremental(p: ScheduleProblem, objective: str,
                        warm: FastPathResult, *, iters: int = 4000,
                        tol: float | None = None, shards: int = 1,
                        precision: str = "fp32",
                        device: str | torch.device = "cuda"
                        ) -> FastPathResult:
    """Re-solve a degraded instance starting from a healthy solution.

    `p` is the degraded problem (same coflow/flow indexing as the healthy
    one — core.failures.degrade_problem builds it); `warm` is the healthy
    instance's FastPathResult.  Routes over failed edges are dropped,
    affected flows are re-routed via the decomposed healthy paths, and
    PDHG restarts from the projected primal/dual state instead of zero
    (solve_lp's ladder, on `device` as in solve_fast).  Output is a full
    FastPathResult (packed, exactly re-scored) and can itself warm-start
    further re-solves (cascading failures)."""
    dev = _device.resolve(device)
    lp, idx = build_routing_lp(p, objective)
    x0, y0 = project_warm_start(warm, p, lp, idx)
    res = solve_lp(lp, iters=iters, tol=tol, x0=x0, y0=y0, shards=shards,
                   precision=precision, device=dev)
    return _assemble_fast_result(p, lp, idx, res)


def _warm_usable(w: FastPathResult | None, p: ScheduleProblem) -> bool:
    """Does `w` carry PDHG state over `p`'s edge/wavelength indexing?"""
    return (w is not None and w.index is not None and w.lp_x is not None
            and w.schedule is not None
            and w.schedule.shape[1:3] == (p.topo.n_edges,
                                          p.topo.n_wavelengths))


def solve_fast_warm(p: ScheduleProblem, objective: str = "energy", *,
                    warm: FastPathResult | None = None,
                    flow_map: np.ndarray | None = None,
                    iters: int = 4000, tol: float | None = None,
                    chunk: int = 250, bucket: bool = True, shards: int = 1,
                    precision: str = "fp32",
                    device: str | torch.device = "cuda") -> FastPathResult:
    """Single-instance fast path with an optional projected warm start and
    the adaptive convergence loop.

    This is the epoch re-solve primitive of the rolling-horizon arrival
    engine (core.arrivals): unlike solve_fast — whose restart ladder
    always spends its full first rung — the adaptive chunked dispatch
    (solve_lp_batch with B=1) freezes within one `chunk`-iteration
    residual check of convergence, so a good warm start actually shows
    up as saved iterations and wall time.

    `warm` is a previous FastPathResult to project onto this problem
    (project_warm_start); `flow_map[i]` names the warm instance's flow
    that flow i of `p` continues (-1 = new flow, identity when None).
    The start degrades to cold, as the reference's does: if `warm` lacks
    PDHG state, its topology shape differs from `p`'s (different
    edge/wavelength indexing — the projection would be meaningless), or
    the projection itself raises, the solve starts from zero, and
    `warm_started` on the result records which ran.  Only the projection
    is guarded; a failure of the solve itself propagates.  `device` as in
    solve_fast."""
    dev = _device.resolve(device)
    lp, idx = build_routing_lp(p, objective)
    warm_starts = None
    if _warm_usable(warm, p):
        try:
            warm_starts = [project_warm_start(warm, p, lp, idx,
                                              flow_map=flow_map)]
        except (ValueError, KeyError, IndexError):
            warm_starts = None         # structure changed -> cold start
    res = solve_lp_batch([lp], iters=iters, tol=tol, chunk=chunk,
                         warm_starts=warm_starts, bucket=bucket,
                         shards=shards, precision=precision, device=dev)[0]
    out = _assemble_fast_result(p, lp, idx, res)
    out.warm_started = warm_starts is not None
    return out


def solve_fast_group(problems: list[ScheduleProblem],
                     objectives: list[str] | str = "energy", *,
                     warm: list[FastPathResult | None] | None = None,
                     flow_maps: list[np.ndarray | None] | None = None,
                     iters: int = 4000, tol: float | None = None,
                     adaptive: bool = True, chunk: int = 250,
                     bucket: bool = True, shards: int = 1,
                     precision: str = "fp32",
                     device: str | torch.device = "cuda"
                     ) -> list[FastPathResult]:
    """One stacked dispatch over a heterogeneous tenant group.

    Like solve_fast_ensemble it block-stacks arbitrary instances into
    one adaptive PDHG dispatch, but each member carries its *own*
    objective ("energy" or "time") and its own rolling-horizon warm
    state.

    `warm[i]` is member i's previous-epoch FastPathResult (or None for
    a cold member) and `flow_maps[i]` names, per flow of `problems[i]`,
    the warm instance's flow it continues (-1 = new; see
    project_warm_start).  Warm projection degrades per member exactly
    like solve_fast_warm: a member whose warm state is missing,
    shape-incompatible, or whose projection raises starts cold (zero
    iterates) without disturbing its group-mates; the returned results'
    `warm_started` flags record what really ran.

    Because stacked PDHG decouples exactly over the blocks, every
    member's trajectory — and therefore its schedule and metrics —
    matches its own solve_fast_warm solve with the same `chunk`, up to
    the order of each row's sum.  Degenerate members (zero flows) solve
    in closed form inside solve_lp_batch and never widen the dispatch.
    `device` as in solve_fast."""
    dev = _device.resolve(device)
    if not problems:
        return []
    B = len(problems)
    if isinstance(objectives, str):
        objectives = [objectives] * B
    if len(objectives) != B:
        raise ValueError(f"{len(objectives)} objectives for {B} problems")
    warm_list = warm if warm is not None else [None] * B
    maps = flow_maps if flow_maps is not None else [None] * B
    if len(warm_list) != B or len(maps) != B:
        raise ValueError("warm/flow_maps length must match problems")
    built = [build_routing_lp(p, o) for p, o in zip(problems, objectives)]
    starts: list[tuple[np.ndarray, np.ndarray]] = []
    flags: list[bool] = []
    for p, (lp, idx), w, fm in zip(problems, built, warm_list, maps):
        x0y0 = None
        if _warm_usable(w, p):
            try:
                x0y0 = project_warm_start(w, p, lp, idx, flow_map=fm)
            except (ValueError, KeyError, IndexError):
                x0y0 = None            # structure changed -> cold member
        starts.append(x0y0 if x0y0 is not None
                      else (np.zeros(lp.n), np.zeros(lp.m)))
        flags.append(x0y0 is not None)
    lps = [lp for lp, _ in built]
    results = solve_lp_batch(lps, iters=iters, tol=tol, adaptive=adaptive,
                             chunk=chunk,
                             warm_starts=starts if any(flags) else None,
                             bucket=bucket, shards=shards,
                             precision=precision, device=dev)
    out = []
    for p, (lp, idx), res, f in zip(problems, built, results, flags):
        r = _assemble_fast_result(p, lp, idx, res)
        r.warm_started = f
        out.append(r)
    return out
