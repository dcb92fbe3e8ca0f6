"""The reference's default PDHG lowering (backend="xla") in the port.

The reference keeps K in COO and lets XLA lower both mat-vecs to
scatter-adds; kernels/pdhg_coo.py writes down the order they follow on a
CPU (each row and column summed one entry at a time in COO entry order,
K^T y seeded with c, x - tau g and y + sig r each rounded once).  Here:

  * the port's plain COO burst is bitwise a numpy emulation of that
    order (np.add.at, the two fused multiply-adds rounded once from
    float64);
  * it is bitwise the reference's own xla functions (`_pdhg_resume`,
    `_pdhg_run_adaptive`, `_pdhg_run_batch` over `pad_and_stack`) and
    solves, where a probe shows that this host's XLA orders the
    reference's scatters that way (`_xla_order_probe`); elsewhere those
    tests skip with the probe's reason, and the tolerance tests (1e-5
    of max|x|, metrics within 1e-4, the same restart rungs) always run;
  * bucketing is value-neutral, the dispatch counters count the
    reference's shapes, and backend= reaches the search, the service,
    run_online, the policies and the sweep CLI;
  * backend="xla" on the card raises without one, and the scale knobs
    (shards > 1, bf16) refuse it as the reference does.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import search as r_search
from repro import service as r_service
from repro.core import arrivals as r_arrivals
from repro.core import policies as r_policies
from repro.core import solver as r_solver
from repro.core import timeslot as r_timeslot
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro.search import optimize as r_optimize
from repro.sweep import runner as r_runner
from repro_torch import convert, search, service
from repro_torch.core import (arrivals, policies, solver, timeslot, topology,
                              traffic, verify)
from repro_torch.kernels import ops, pdhg_coo
from repro_torch.sweep import __main__ as sweep_main
from repro_torch.sweep import runner

GOLDEN_PATTERN = dict(n_map=4, n_reduce=3, total_gbits=8.0)
TOPOS = ("spine-leaf", "fat-tree", "bcube", "dcell", "pon3", "pon5")
# one objective a topology where a test solves each once
CELLS = [("spine-leaf", "time"), ("fat-tree", "energy"), ("bcube", "time"),
         ("dcell", "energy"), ("pon3", "time"), ("pon5", "energy")]
ORDER_ITERS = 300
METRIC_RTOL = 1e-4
# a trajectory held to the reference without the probe: the same
# iterations, each x within this share of max|x|
X_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these solves run thousands of tiny torch ops,
    which spinning thread pools slow down under parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(mod_topology, mod_traffic, mod_timeslot, name, seed=0,
             pat=GOLDEN_PATTERN):
    topo = mod_topology.build(name)
    cf = mod_traffic.generate_batch(
        topo, mod_traffic.pattern("uniform", **pat), [seed])[0]
    return mod_timeslot.ScheduleProblem(
        topo, cf, n_slots=mod_timeslot.suggest_n_slots(topo, cf),
        path_slack=2)


def _lps(name, objective, seed=0):
    """The same routing LP from both packages (bitwise equal builds)."""
    rlp, _ = r_solver.build_routing_lp(
        _problem(r_topology, r_traffic, r_timeslot, name, seed), objective)
    lp, _ = solver.build_routing_lp(
        _problem(topology, traffic, timeslot, name, seed), objective)
    return rlp, lp


def _args(lp):
    """solve_lp's xla arguments as numpy, before the cast to float32."""
    xmax = np.where(np.isfinite(lp.xmax), lp.xmax, 1e12)
    cscale = max(float(np.abs(lp.c).max(initial=0.0)), 1e-12)
    return (lp.c / cscale, lp.row, lp.col, lp.val, lp.b, lp.h, xmax)


# ---------------------------------------------------------------------------
# the order model in numpy
# ---------------------------------------------------------------------------

def _fma(a, b, c, fused=True):
    """a * b + c in float32: rounded once from float64 (fused), or the
    product rounded first."""
    if fused:
        return (a.astype(np.float64) * b + c).astype(np.float32)
    return (a * b).astype(np.float32) + c


def _np_model(c, row, col, val, b, h, xmax, m_eq, iters, x, y, keep_n=None,
              keep_m=None, fused=True, from_c=True):
    """The order model over COO in numpy: np.add.at adds one entry at a
    time, in entry order.  fused=False rounds the two updates twice and
    from_c=False seeds K^T y with zeros (adding c after): each is what
    the model rules out."""
    f32 = np.float32
    c, val, xmax = (np.asarray(a, f32) for a in (c, val, xmax))
    q = np.concatenate([b, h]).astype(f32)
    n, m = len(c), len(q)
    keep_n = np.zeros(n, bool) if keep_n is None else keep_n
    keep_m = np.zeros(m, bool) if keep_m is None else keep_m
    a = np.abs(val)
    cs = np.zeros(n, f32)
    np.add.at(cs, col, a)
    rs = np.zeros(m, f32)
    np.add.at(rs, row, a)
    tau = f32(1) / np.maximum(cs, f32(1e-12))
    sig = f32(1) / np.maximum(rs, f32(1e-12))
    ub = np.arange(m) >= m_eq
    x, y = np.asarray(x, f32), np.asarray(y, f32)
    for _ in range(iters):
        if from_c:
            g = c.copy()
            np.add.at(g, col, val * y[row])
        else:
            g = np.zeros(n, f32)
            np.add.at(g, col, val * y[row])
            g = g + c
        xn = np.minimum(np.maximum(_fma(-tau, g, x, fused), f32(0)), xmax)
        xn = np.where(keep_n, x, xn)
        xb = f32(2) * xn - x
        kx = np.zeros(m, f32)
        np.add.at(kx, row, val * xb[col])
        yn = _fma(sig, kx - q, y, fused)
        yn = np.where(ub, np.maximum(yn, f32(0)), yn)
        x, y = xn, np.where(keep_m, y, yn)
    kx = np.zeros(m, f32)
    np.add.at(kx, row, val * x[col])
    r = kx - q
    return x, y, np.where(ub, np.maximum(r, f32(0)), np.abs(r))


def _random_lp(seed, m=48, n=64, nnz=400):
    """A random COO LP (duplicate entries included), rows [m/2, m)
    inequalities."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n), rng.integers(0, m, nnz),
            rng.integers(0, n, nnz), rng.standard_normal(nnz),
            rng.standard_normal(m // 2), rng.random(m - m // 2),
            rng.random(n) * 3.0, m // 2)


@functools.lru_cache(maxsize=None)
def _xla_order_probe() -> str | None:
    """None when this host's XLA runs the reference's COO update in the
    order model's order, else the reason it does not.  Checks, each on
    data where the alternatives give other bits: `y + s * r` and
    `x - t * g` rounded once; `c + zeros.at[i].add(v)` seeded with c;
    a scatter adding in entry order; and the reference's own
    `_pdhg_resume` on a small random LP, bitwise the numpy model."""
    rng = np.random.default_rng(7)
    y, s, r = (rng.standard_normal(4096).astype(np.float32)
               for _ in range(3))
    got = np.asarray(jax.jit(lambda y, s, r: y + s * r)(y, s, r))
    if not np.array_equal(got, _fma(s, r, y)):
        return "this host's XLA does not round y + s * r once"
    got = np.asarray(jax.jit(lambda x, t, g: x - t * g)(y, s, r))
    if not np.array_equal(got, _fma(-s, r, y)):
        return "this host's XLA does not round x - t * g once"
    tiny = np.float32(2.0 ** -24)
    idx = np.array([0, 0, 1, 1, 1])
    v = np.array([tiny, tiny, 1e8, 1.0, -1e8], np.float32)
    c = np.array([1.0, 0.0], np.float32)
    got = np.asarray(jax.jit(
        lambda c, i, v: c + jnp.zeros(2).at[i].add(v))(c, idx, v))
    if got[0] != np.float32(1.0):
        return "this host's XLA does not seed c + zeros.at[i].add(v) with c"
    if got[1] != np.float32(0.0):
        return "this host's XLA does not scatter-add in entry order"
    c, row, col, val, b, h, xmax, m_eq = _random_lp(0)
    m, n = len(b) + len(h), len(c)
    x, yy, _, _ = r_solver._pdhg_resume(
        *(jnp.asarray(a) for a in (c, row, col, val, b, h, xmax)),
        jnp.zeros(n), jnp.zeros(m), m, n, m_eq, 20)
    want = _np_model(c, row, col, val, b, h, xmax, m_eq, 20, np.zeros(n),
                     np.zeros(m))
    if not (np.array_equal(np.asarray(x), want[0])
            and np.array_equal(np.asarray(yy), want[1])):
        return ("this host's XLA runs the reference's _pdhg_resume in "
                "another order than the model's")
    return None


def _bitwise_or_skip():
    reason = _xla_order_probe()
    if reason is not None:
        pytest.skip(reason)


def _close_x(got, want):
    """Within X_RTOL of the largest |x| of the reference's iterate."""
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    assert float(np.abs(np.asarray(got, np.float64) - want).max(
        initial=0.0)) <= X_RTOL * scale


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(dtype)


# ---------------------------------------------------------------------------
# the plain version is the order model
# ---------------------------------------------------------------------------

def _plain(lp_args, m_eq, iters, x0, y0, keep_n, keep_m):
    c, row, col, val, b, h, xmax = lp_args
    m, n = len(b) + len(h), len(c)
    q, tau, sig, cols, rows, ub = solver._pdhg_ops(c, row, col, val, b, h,
                                                   m, n, m_eq, "cpu")
    return [t.numpy() for t in pdhg_coo.coo_update_burst(
        _t(x0), _t(y0), _t(c), tau, _t(xmax), q, sig, ub,
        _t(keep_n, torch.bool), _t(keep_m, torch.bool), cols, rows,
        iters=iters)]


@pytest.mark.parametrize("name,objective", CELLS)
def test_plain_burst_is_the_numpy_order_model(name, objective):
    """ORDER_ITERS iterations cold on each paper topology: x, y and the
    residual bitwise the numpy model; the model rounding the updates
    twice, or seeding K^T y with zeros, gives other bits."""
    _, lp = _lps(name, objective)
    args = _args(lp)
    zn, zm = np.zeros(lp.n), np.zeros(lp.m)
    got = _plain(args, lp.m_eq, ORDER_ITERS, zn, zm, zn > 0, zm > 0)
    want = _np_model(*args, lp.m_eq, ORDER_ITERS, zn, zm)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    for kw in (dict(fused=False), dict(from_c=False)):
        other = _np_model(*args, lp.m_eq, ORDER_ITERS, zn, zm, **kw)
        assert not np.array_equal(other[0], want[0]), kw


def test_plain_burst_holds_frozen_coordinates_as_the_model():
    """A random LP from a random start with a fifth of the coordinates
    held: bitwise the model, and held coordinates unmoved."""
    c, row, col, val, b, h, xmax, m_eq = _random_lp(3, m=200, n=300,
                                                    nnz=2000)
    rng = np.random.default_rng(4)
    m, n = len(b) + len(h), len(c)
    x0 = (rng.random(n) * xmax).astype(np.float32)
    y0 = rng.standard_normal(m).astype(np.float32)
    keep_n, keep_m = rng.random(n) < 0.2, rng.random(m) < 0.2
    got = _plain((c, row, col, val, b, h, xmax), m_eq, 50, x0, y0, keep_n,
                 keep_m)
    want = _np_model(c, row, col, val, b, h, xmax, m_eq, 50, x0, y0, keep_n,
                     keep_m)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.array_equal(got[0][keep_n], x0[keep_n])
    assert np.array_equal(got[1][keep_m], y0[keep_m])


# ---------------------------------------------------------------------------
# the plan's work order (the card's tiers)
# ---------------------------------------------------------------------------

# (LONG, CHUNK_OUTPUTS, CHUNK_ENTRIES): the plan's, many small tiers, and
# one tier of single-output chunks in index order (no long outputs)
TIERINGS = [None, (4, 3, 16), (10 ** 9, 1, 10 ** 9)]


def _tiered_plan(monkeypatch, row, col, m, n, tiering):
    if tiering is not None:
        for name, v in zip(("LONG", "CHUNK_OUTPUTS", "CHUNK_ENTRIES"),
                           tiering):
            monkeypatch.setattr(pdhg_coo, name, v)
    return pdhg_coo.coo_plan(row, col, m, n)


def _tier_lps():
    """A paper LP with long outputs in both directions (the min-time
    LP's theta column) and a random one with duplicate entries."""
    _, lp = _lps("spine-leaf", "time")
    c, row, col, val, b, h, _, m_eq = _random_lp(6, m=120, n=90, nnz=1500)
    return [(lp.row, lp.col, lp.val, lp.m, lp.n),
            (row, col, val, len(b) + len(h), len(c))]


@pytest.mark.parametrize("tiering", TIERINGS)
def test_plan_tiers_partition_the_outputs(monkeypatch, tiering):
    """Each direction's work order holds every output once: the long
    ones first, longest first, then the rest in index order, cut into
    chunks within the plan's bounds that cover them in order."""
    for i, (row, col, _, m, n) in enumerate(_tier_lps()):
        plan = _tiered_plan(monkeypatch, row, col, m, n, tiering)
        for side, n_out, key in ((plan.cols, n, col), (plan.rows, m, row)):
            counts = np.bincount(key, minlength=n_out)
            assert np.array_equal(np.sort(side.order), np.arange(n_out))
            longs = side.order[:side.n_long]
            shorts = side.order[side.n_long:]
            assert np.all(counts[longs] > pdhg_coo.LONG)
            block = counts[side.order[:side.n_block]]
            assert np.all(block > pdhg_coo.CHUNK_ENTRIES)
            assert np.all(counts[side.order[side.n_block:side.n_long]]
                          <= pdhg_coo.CHUNK_ENTRIES)
            assert np.all(counts[shorts] <= pdhg_coo.LONG)
            assert np.all(np.diff(counts[longs]) <= 0)
            assert np.all(np.diff(shorts) > 0)
            ch = side.chunk
            assert ch[0] == side.n_long and ch[-1] == n_out
            assert np.all(np.diff(ch) > 0)
            assert np.all(np.diff(ch) <= pdhg_coo.CHUNK_OUTPUTS)
            assert np.all(np.diff(side.off[ch]) <= pdhg_coo.CHUNK_ENTRIES)
        if tiering is None and i == 0:     # the theta column is long
            assert plan.cols.n_long > 0


@pytest.mark.parametrize("tiering", TIERINGS)
def test_plan_keeps_each_outputs_entries_contiguous_in_coo_order(
        monkeypatch, tiering):
    """Position p's entries are off[p]:off[p+1] of the permutation: all
    of output order[p]'s entries, in COO entry order, each gathering the
    other index of its entry."""
    for row, col, _, m, n in _tier_lps():
        plan = _tiered_plan(monkeypatch, row, col, m, n, tiering)
        for side, key, other in ((plan.cols, col, row),
                                 (plan.rows, row, col)):
            assert np.array_equal(np.sort(side.perm), np.arange(len(key)))
            for p, o in enumerate(side.order):
                ents = side.perm[side.off[p]:side.off[p + 1]]
                assert np.array_equal(ents, np.flatnonzero(key == o))
            assert np.array_equal(side.out, key[side.perm])
            assert np.array_equal(side.idx, other[side.perm])


def _walk(side, val, vec, start):
    """The card's walk of one direction in numpy (kernels/csrc/
    pdhg_coo.cu): each work item's products val * vec[idx] staged in
    float32 (a long output CHUNK_ENTRIES at a time, as a warp stages it;
    a block stages more at once, which changes no add), then each output
    added from its start one product at a time, in order."""
    f32 = np.float32
    out = np.asarray(start, f32).copy()
    prod = (val * vec[side.idx]).astype(f32)
    for p in range(side.n_long):
        s = out[side.order[p]]
        for e0 in range(side.off[p], side.off[p + 1],
                        pdhg_coo.CHUNK_ENTRIES):
            staged = prod[e0:min(e0 + pdhg_coo.CHUNK_ENTRIES,
                                 side.off[p + 1])]
            for v in staged:
                s = f32(s + v)
        out[side.order[p]] = s
    for c in range(len(side.chunk) - 1):
        p0, p1 = side.chunk[c], side.chunk[c + 1]
        staged = prod[side.off[p0]:side.off[p1]]
        for p in range(p0, p1):
            s = out[side.order[p]]
            for v in staged[side.off[p] - side.off[p0]:
                            side.off[p + 1] - side.off[p0]]:
                s = f32(s + v)
            out[side.order[p]] = s
    return out


@pytest.mark.parametrize("tiering", TIERINGS)
def test_plain_bits_do_not_change_with_the_tiering(monkeypatch, tiering):
    """The plain burst over each tiering's directions is bitwise the one
    over the plan's own, and each direction's sums are bitwise the
    card's walk of its work items emulated in numpy."""
    rng = np.random.default_rng(8)
    for row, col, val, m, n in _tier_lps():
        plans = [pdhg_coo.coo_plan(row, col, m, n),
                 _tiered_plan(monkeypatch, row, col, m, n, tiering)]
        runs = []
        x0 = rng.random(n).astype(np.float32)
        y0 = rng.standard_normal(m).astype(np.float32)
        c, q = (rng.standard_normal(k).astype(np.float32) for k in (n, m))
        for plan in plans:
            op = pdhg_coo.coo_fill(plan, val)
            cols, rows = pdhg_coo.coo_directions(op, "cpu")
            runs.append([t.numpy() for t in pdhg_coo.coo_update_burst(
                _t(x0), _t(y0), _t(c), _t(op.tau), _t(np.full(n, 2.0)),
                _t(q), _t(op.sig), _t(np.arange(m) >= m // 2, torch.bool),
                _t(np.zeros(n), torch.bool), _t(np.zeros(m), torch.bool),
                cols, rows, iters=20)])
            for side, d, vec, start in ((plan.cols, cols, y0, c),
                                        (plan.rows, rows, x0,
                                         np.zeros(m))):
                want = pdhg_coo._sums(_t(start), d, _t(vec)).numpy()
                got = _walk(side, d.val.numpy(), vec, start)
                assert np.array_equal(got, want)
        for g, w in zip(*runs):
            assert np.array_equal(g, w)


def _round_f32(exact) -> np.float32:
    """The float32 nearest a rational (ties to the even significand)."""
    from fractions import Fraction
    v = np.float32(float(exact))
    cands = [np.nextafter(v, np.float32(-np.inf)), v,
             np.nextafter(v, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - exact) for c in cands]
    best = min(dist)
    ties = [c for c, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def test_fma32_rounds_once():
    """fma32 against exact rational arithmetic rounded once to float32,
    on values where rounding a * b first gives other bits."""
    from fractions import Fraction
    rng = np.random.default_rng(5)
    a, b, c = (rng.standard_normal(2000).astype(np.float32)
               for _ in range(3))
    got = pdhg_coo.fma32(_t(a), _t(b), _t(c)).numpy()
    exact = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                 + Fraction(float(z)))
                      for x, y, z in zip(a, b, c)], np.float32)
    assert np.count_nonzero(got != (a * b + c)) > 0
    assert np.array_equal(got, exact)


# ---------------------------------------------------------------------------
# against the reference's own xla functions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _resume_pair(name, objective):
    rlp, lp = _lps(name, objective)
    rargs = _args(rlp)
    x, y, primal, _ = r_solver._pdhg_resume(
        *(jnp.asarray(a) for a in rargs), jnp.zeros(rlp.n),
        jnp.zeros(rlp.m), rlp.m, rlp.n, rlp.m_eq, ORDER_ITERS)
    gx, gy, gp, _ = solver._pdhg_resume(
        *_args(lp), np.zeros(lp.n), np.zeros(lp.m), lp.m, lp.n, lp.m_eq,
        ORDER_ITERS, device="cpu")
    return ((gx.numpy(), gy.numpy(), float(gp)),
            (np.asarray(x), np.asarray(y), float(primal)))


@pytest.mark.parametrize("name,objective", CELLS)
def test_resume_is_the_references_bitwise(name, objective):
    _bitwise_or_skip()
    got, want = _resume_pair(name, objective)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("name,objective", CELLS)
def test_resume_tracks_the_reference(name, objective):
    got, want = _resume_pair(name, objective)
    _close_x(got[0], want[0])
    assert got[2] == pytest.approx(want[2], rel=1e-3, abs=1e-6)


def _adaptive_args(name):
    """Three seeds of `name` stacked block-diagonally, with the
    reference's instance maps and tolerances (no bucketing)."""
    rlps = [_lps(name, "energy", seed)[0] for seed in range(3)]
    bs = r_solver.block_stack(rlps)
    g = bs.lp
    inst_n = np.repeat(np.arange(3), np.diff(bs.n_off)).astype(np.int32)
    inst_m = np.concatenate([np.repeat(np.arange(3), np.diff(bs.eq_off)),
                             np.repeat(np.arange(3), np.diff(bs.ub_off))]
                            ).astype(np.int32)
    tols = np.array([1e-4 * max(float(np.abs(lp.b).max()), 1.0)
                     for lp in rlps])
    return (g.c, g.row, g.col, g.val, g.b, g.h, g.xmax), g, tols, inst_n, \
        inst_m


@functools.lru_cache(maxsize=None)
def _adaptive_pair(name):
    args, g, tols, inst_n, inst_m = _adaptive_args(name)
    want = r_solver._pdhg_run_adaptive(
        *(jnp.asarray(a) for a in args), jnp.zeros(g.n), jnp.zeros(g.m),
        jnp.asarray(tols), jnp.asarray(inst_n), jnp.asarray(inst_m), 3,
        g.m, g.n, g.m_eq, 250, 6)
    got = solver._pdhg_run_adaptive(
        *args, np.zeros(g.n), np.zeros(g.m), tols, inst_n, inst_m, 3, g.m,
        g.n, g.m_eq, 250, 6, device="cpu")
    return ([t.numpy() for t in got], [np.asarray(a) for a in want])


@pytest.mark.parametrize("name", ["spine-leaf", "pon3"])
def test_run_adaptive_is_the_references_bitwise(name):
    """Three stacked instances, chunks of 250: x, y, the per-instance
    residuals and chunks used bitwise the reference's."""
    _bitwise_or_skip()
    got, want = _adaptive_pair(name)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("name", ["spine-leaf", "pon3"])
def test_run_adaptive_tracks_the_reference(name):
    got, want = _adaptive_pair(name)
    _close_x(got[0], want[0])
    assert np.array_equal(got[3], want[3])       # the chunks each ran


def test_run_adaptive_without_a_chunk_reports_the_start():
    """max_chunks=0 runs no burst: the start comes back with its own
    residuals and no chunk used, as in the reference."""
    args, g, tols, inst_n, inst_m = _adaptive_args("pon3")
    rng = np.random.default_rng(2)
    x0 = rng.random(g.n).astype(np.float32)
    y0 = np.zeros(g.m, np.float32)
    want = r_solver._pdhg_run_adaptive(
        *(jnp.asarray(a) for a in args), jnp.asarray(x0), jnp.asarray(y0),
        jnp.asarray(tols), jnp.asarray(inst_n), jnp.asarray(inst_m), 3,
        g.m, g.n, g.m_eq, 250, 0)
    got = solver._pdhg_run_adaptive(
        *args, x0, y0, tols, inst_n, inst_m, 3, g.m, g.n, g.m_eq, 250, 0,
        device="cpu")
    assert np.array_equal(got[0].numpy(), x0)
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _batch_pair():
    rlps = [_lps(name, "time")[0] for name in ("spine-leaf", "pon3")]
    lps = [_lps(name, "time")[1] for name in ("spine-leaf", "pon3")]
    rb, pb = r_solver.pad_and_stack(rlps), solver.pad_and_stack(lps)
    for f in ("c", "row", "col", "val", "b", "h", "xmax"):
        assert np.array_equal(getattr(rb, f), getattr(pb, f)), f
    assert (rb.m, rb.n, rb.m_eq, rb.n_true) == (pb.m, pb.n, pb.m_eq,
                                                pb.n_true)
    B = len(lps)
    want = r_solver._pdhg_run_batch(
        *(jnp.asarray(getattr(rb, f))
          for f in ("c", "row", "col", "val", "b", "h", "xmax")),
        jnp.zeros((B, rb.n)), jnp.zeros((B, rb.m)), rb.m, rb.n, rb.m_eq,
        ORDER_ITERS)
    got = solver._pdhg_run_batch(
        pb.c, pb.row, pb.col, pb.val, pb.b, pb.h, pb.xmax,
        np.zeros((B, pb.n)), np.zeros((B, pb.m)), pb.m, pb.n, pb.m_eq,
        ORDER_ITERS, device="cpu")
    return [t.numpy() for t in got], [np.asarray(a) for a in want]


def test_run_batch_over_pad_and_stack_is_the_references_bitwise():
    _bitwise_or_skip()
    got, want = _batch_pair()
    for g, w in zip(got[:3], want[:3]):          # x, y, primal
        assert np.array_equal(g, w)


def test_run_batch_over_pad_and_stack_tracks_the_reference():
    got, want = _batch_pair()
    for i in range(len(got[0])):
        _close_x(got[0][i], want[0][i])


def test_run_cold_keeps_the_historical_interface():
    """_pdhg_run: the cold start's (x, primal, gap), as _pdhg_resume from
    zeros gives them."""
    _, lp = _lps("pon3", "energy")
    x, primal, gap = solver._pdhg_run(*_args(lp), lp.m, lp.n, lp.m_eq, 200,
                                      200, device="cpu")
    x2, _, primal2, gap2 = solver._pdhg_resume(
        *_args(lp), np.zeros(lp.n), np.zeros(lp.m), lp.m, lp.n, lp.m_eq,
        200, device="cpu")
    assert torch.equal(x, x2) and float(primal) == float(primal2)
    assert float(gap) == float(gap2)


# ---------------------------------------------------------------------------
# solve_lp, solve_fast: the reference's default
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fast_pair(name, objective):
    rp = _problem(r_topology, r_traffic, r_timeslot, name)
    p = _problem(topology, traffic, timeslot, name)
    return (solver.solve_fast(p, objective, backend="xla", device="cpu"),
            r_solver.solve_fast(rp, objective), p)


@pytest.mark.parametrize("name,objective", CELLS)
def test_solve_lp_is_the_references_bitwise(name, objective):
    """solve_fast's LP under backend="xla" is the reference's default
    solve_lp: x and y (float32, as the reference returns them) and the
    iterations bitwise."""
    _bitwise_or_skip()
    got, want, _ = _fast_pair(name, objective)
    assert got.lp_x.dtype == want.lp_x.dtype == np.float32
    assert np.array_equal(got.lp_x, want.lp_x)
    assert np.array_equal(got.lp_y, want.lp_y)
    assert got.iterations == want.iterations
    assert got.lp_primal_residual == want.lp_primal_residual


@pytest.mark.parametrize("objective", ["energy", "time"])
@pytest.mark.parametrize("name", TOPOS)
def test_solve_fast_tracks_the_reference(name, objective):
    """Every paper cell: certified, on the reference's restart rung, x
    within X_RTOL of max|x|, metrics within 1e-4."""
    got, want, p = _fast_pair(name, objective)
    verify.check_schedule(p, got.schedule).assert_ok(f"{name}/{objective}")
    assert got.iterations == want.iterations
    _close_x(got.lp_x, want.lp_x)
    for k in ("energy_j", "completion_s", "fairness_term"):
        assert getattr(got.metrics, k) == pytest.approx(
            getattr(want.metrics, k), rel=METRIC_RTOL, abs=1e-9), k


@pytest.mark.parametrize("objective", ["energy", "time"])
@pytest.mark.parametrize("name", ["spine-leaf", "pon3"])
def test_golden_metrics_hold_under_xla(name, objective):
    import json
    import pathlib
    golden = json.loads((pathlib.Path(__file__).parent / "golden"
                         / "metrics.json").read_text())
    want = golden[f"{name}/min-{objective}/seed0"]
    got = _fast_pair(name, objective)[0].metrics
    for k in ("energy_j", "completion_s", "fairness_term"):
        assert getattr(got, k) == pytest.approx(want[k], rel=METRIC_RTOL,
                                                abs=1e-9), k


def test_warm_resolve_follows_the_reference():
    """resolve_incremental from a healthy xla solve onto a link3
    degradation: the reference's rung, x within X_RTOL (bitwise where
    the probe holds)."""
    from repro.core import failures as r_failures
    from repro_torch.core import failures
    rp = _problem(r_topology, r_traffic, r_timeslot, "spine-leaf")
    p = _problem(topology, traffic, timeslot, "spine-leaf")
    rw = r_solver.solve_fast(rp, "energy")
    w = solver.solve_fast(p, "energy", backend="xla", device="cpu")
    rd = r_failures.degrade_problem(rp, r_failures.sample(rp.topo, "link3",
                                                          0))
    d = failures.degrade_problem(p, failures.sample(p.topo, "link3", 0))
    want = r_solver.resolve_incremental(rd, "energy", rw)
    got = solver.resolve_incremental(d, "energy", w, backend="xla",
                                     device="cpu")
    assert got.iterations == want.iterations
    _close_x(got.lp_x, want.lp_x)
    if _xla_order_probe() is None:
        assert np.array_equal(got.lp_x, want.lp_x)


# ---------------------------------------------------------------------------
# the batch, bucketing and the dispatch counters
# ---------------------------------------------------------------------------

def _pon3_probs(mod_topology, mod_traffic, mod_timeslot, seeds=range(3)):
    topo = mod_topology.build("pon3")
    pat = mod_traffic.pattern("uniform", n_map=3, n_reduce=2,
                              total_gbits=6.0)
    return [mod_timeslot.ScheduleProblem(
                topo, cf, n_slots=mod_timeslot.suggest_n_slots(topo, cf),
                path_slack=2)
            for cf in mod_traffic.generate_batch(topo, pat, seeds)]


def test_bucket_grid_and_padding_match_reference():
    for x in list(range(1, 70)) + [100, 333, 1024, 5000, 123457]:
        assert solver._bucket(x) == r_solver._bucket(x)
    bs = [solver.block_stack([solver.build_routing_lp(p, "time")[0]
                              for p in _pon3_probs(topology, traffic,
                                                   timeslot)])]
    rbs = [r_solver.block_stack([r_solver.build_routing_lp(p, "time")[0]
                                 for p in _pon3_probs(r_topology, r_traffic,
                                                      r_timeslot)])]
    got, gdims = solver._pad_for_buckets(bs[0].lp)
    want, wdims = r_solver._pad_for_buckets(rbs[0].lp)
    assert gdims == wdims
    for f in ("c", "row", "col", "val", "b", "h", "xmax"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("objective", ["energy", "time"])
def test_bucketed_batch_matches_unbucketed(objective):
    """The port's counterpart of tests/test_build_cache.py's bucketed
    case, under backend="xla": bucketing changes no bit (the padding is
    value-neutral and its zero entries stay out of the operator)."""
    probs = _pon3_probs(topology, traffic, timeslot)
    kw = dict(iters=400, tol=2e-3, backend="xla", device="cpu")
    on = solver.solve_fast_batch(probs, objective, bucket=True, **kw)
    off = solver.solve_fast_batch(probs, objective, bucket=False, **kw)
    for a, b in zip(on, off):
        assert np.array_equal(a.lp_x, b.lp_x)
        assert np.array_equal(a.lp_y, b.lp_y)
        assert a.iterations == b.iterations
        assert a.metrics.energy_j == b.metrics.energy_j


def test_bucketed_warm_matches_unbucketed():
    p = _problem(topology, traffic, timeslot, "spine-leaf")
    warm = solver.solve_fast(p, "energy", iters=300, tol=5e-3,
                             backend="xla", device="cpu")
    wide = timeslot.rehorizon(p, 2 * p.n_slots)
    kw = dict(warm=warm, iters=300, tol=5e-3, backend="xla", device="cpu")
    on = solver.solve_fast_warm(wide, "energy", bucket=True, **kw)
    off = solver.solve_fast_warm(wide, "energy", bucket=False, **kw)
    assert on.warm_started and off.warm_started
    assert np.array_equal(on.lp_x, off.lp_x)
    assert on.iterations == off.iterations


@pytest.mark.parametrize("adaptive", [True, False])
def test_batch_and_dispatch_counts_follow_the_reference(adaptive):
    """solve_fast_batch under xla against the reference's default: the
    same iterations and dispatch shapes (the counters count the
    reference's bucketed shapes), x within X_RTOL (bitwise where the
    probe holds), every schedule certified."""
    probs = _pon3_probs(topology, traffic, timeslot)
    rprobs = _pon3_probs(r_topology, r_traffic, r_timeslot)
    solver.reset_dispatch_stats()
    r_solver.reset_dispatch_stats()
    kw = dict(iters=400, tol=2e-3, adaptive=adaptive)
    got = solver.solve_fast_batch(probs, "time", backend="xla",
                                  device="cpu", **kw)
    want = r_solver.solve_fast_batch(rprobs, "time", **kw)
    assert (dataclasses.astuple(solver.dispatch_stats())
            == dataclasses.astuple(r_solver.dispatch_stats()))
    assert set(solver._DISPATCH_SHAPES) == set(r_solver._DISPATCH_SHAPES)
    for p, a, b in zip(probs, got, want):
        verify.check_schedule(p, a.schedule).assert_ok("xla batch")
        assert a.iterations == b.iterations
        _close_x(a.lp_x, b.lp_x)
        if _xla_order_probe() is None:
            assert np.array_equal(a.lp_x, b.lp_x)


def test_stacked_members_are_their_solo_solves():
    probs = _pon3_probs(topology, traffic, timeslot)
    kw = dict(backend="xla", device="cpu")
    batch = solver.solve_fast_batch(probs, "energy", **kw)
    for p, b in zip(probs, batch):
        s = solver.solve_fast_batch([p], "energy", **kw)[0]
        assert np.array_equal(s.lp_x, b.lp_x) and s.iterations == b.iterations


# ---------------------------------------------------------------------------
# backend= through the operator paths
# ---------------------------------------------------------------------------

def test_search_xla_matches_the_references_xla_search():
    """The spine-leaf min-time search under xla against the reference's
    xla search on this host (the pin itself is host-dependent, ROADMAP
    queue 3): the same placements, counts and history; identical where
    the probe holds."""
    kw = dict(method="sa", seed=0, generations=1, population=4)
    pat = dict(n_map=4, n_reduce=3, total_gbits=8.0)
    got = convert.search_result_to_arrays(search.optimize_placement(
        topology.build("spine-leaf"), traffic.pattern("uniform", **pat),
        "time", backend="xla", device="cpu", **kw))
    want = convert.search_result_to_arrays(r_search.optimize_placement(
        r_topology.build("spine-leaf"), r_traffic.pattern("uniform", **pat),
        "time", **kw))
    if _xla_order_probe() is None:
        assert repr(got) == repr(want)
    for k in ("method", "objective", "topo_name", "baseline_best",
              "evaluations", "dispatches"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["history"], want["history"],
                               rtol=METRIC_RTOL)


def test_service_replay_byte_identical_under_xla():
    spec = arrivals.ArrivalSpec(n_coflows=2, mean_interarrival_s=2.0)
    pat = traffic.pattern("uniform", n_map=4, n_reduce=3, total_gbits=6.0)
    tenants = [service.TenantSpec(f"t{k}", topology.build("spine-leaf"),
                                  pat, spec, seed=k) for k in range(2)]
    cfg = service.ServiceConfig(iters=1500, tol=2e-3, backend="xla",
                                device="cpu")
    a = service.run_service(tenants, cfg)
    b = service.run_service(tenants, cfg)
    assert a.event_log() == b.event_log() and len(a.events) > 0
    assert a.backlog_gbits == 0.0


def test_run_online_warm_epochs_follow_the_reference():
    """The heavy trace warm under xla against the reference's default
    run: where the probe holds every epoch bitwise (the flows carried and
    the completion times included: ROADMAP queue 3's warm-epoch
    divergence is the pallas lowering's summation order); else the
    epochs' energies within 1e-4."""
    spec_kw = dict(family="poisson", n_coflows=4, mean_interarrival_s=2.0)
    heavy = dict(n_map=4, n_reduce=3, total_gbits=48.0)
    rtrace = r_arrivals.generate_trace(
        r_topology.build("spine-leaf"), r_traffic.pattern("uniform", **heavy),
        r_arrivals.ArrivalSpec(**spec_kw), seed=0)
    trace = convert.trace_from_arrays(convert.trace_to_arrays(rtrace))
    kw = dict(epoch_s=1.0, iters=3000)
    want = r_arrivals.run_online(r_topology.build("spine-leaf"), rtrace,
                                 "energy", **kw)
    got = arrivals.run_online(topology.build("spine-leaf"), trace, "energy",
                              backend="xla", device="cpu", **kw)
    assert got.n_epochs == want.n_epochs > 1
    assert any(e.warm for e in got.epochs)
    for g, w in zip(got.epochs, want.epochs):
        assert g.energy_j == pytest.approx(w.energy_j, rel=METRIC_RTOL)
        if _xla_order_probe() is None:
            for f in ("t_start", "n_flows", "n_slots", "iterations",
                      "executed_slots", "warm", "energy_j", "shipped_gbits",
                      "backlog_gbits"):
                assert getattr(g, f) == getattr(w, f), f
    if _xla_order_probe() is None:
        assert got.mean_response_s == want.mean_response_s
    assert got.backlog_gbits <= 1e-6


def test_fair_lp_policy_under_xla():
    rp = _problem(r_topology, r_traffic, r_timeslot, "pon3")
    p = _problem(topology, traffic, timeslot, "pon3")
    got = policies.get("fair-lp").solve(p, "energy", backend="xla",
                                        device="cpu")
    want = r_policies.get("fair-lp").solve(rp, "energy")
    got.certificate.assert_ok("fair-lp xla")
    assert got.iterations == want.iterations
    assert got.metrics.energy_j == pytest.approx(want.metrics.energy_j,
                                                 rel=METRIC_RTOL)
    # a heuristic ignores the lowering
    a = policies.get("scf").solve(p, "energy", backend="xla", device="cpu")
    b = policies.get("scf").solve(p, "energy", backend="pallas", device="cpu")
    assert np.array_equal(a.schedule, b.schedule)


def test_sweep_cli_runs_backend_xla_on_the_cpu(tmp_path):
    """`--backend xla --device cpu` runs a small sweep; its rows read
    backend xla and match the reference's default run within 1e-4."""
    args = ["--topos", "pon3", "--objectives", "energy", "--patterns",
            "uniform", "--seeds", "2", "--total-gbits", "8", "--n-map", "4",
            "--n-reduce", "3", "--oracle-check", "0"]
    assert sweep_main.main(args + ["--backend", "xla", "--device", "cpu",
                                   "--out", str(tmp_path)]) == 0
    text = (tmp_path / "results.csv").read_text()
    assert ",xla," in text and ",pallas," not in text
    spec = dict(topos=("pon3",), objectives=("energy",),
                patterns=("uniform",), seeds=(0, 1), total_gbits=8.0,
                n_map=4, n_reduce=3)
    got, _ = runner.run_sweep(runner.SweepSpec(**spec, backend="xla",
                                               device="cpu"))
    want, _ = r_runner.run_sweep(r_runner.SweepSpec(**spec))
    for g, w in zip(got, want):
        assert g.backend == w.backend == "xla"
        assert g.energy_j == pytest.approx(w.energy_j, rel=METRIC_RTOL)
        assert g.completion_s == pytest.approx(w.completion_s,
                                               rel=METRIC_RTOL)


# ---------------------------------------------------------------------------
# refusals: no card, the scale knobs, unknown lowerings
# ---------------------------------------------------------------------------

def test_xla_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs")
    p = _problem(topology, traffic, timeslot, "pon3")
    with pytest.raises(RuntimeError, match="is_available"):
        solver.solve_fast(p, "energy", backend="xla")
    with pytest.raises(RuntimeError, match="is_available"):
        sweep_main.main(["--topos", "pon3", "--seeds", "1", "--backend",
                         "xla", "--oracle-check", "0"])
    _, lp = _lps("pon3", "energy")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        solver._pdhg_resume(*_args(lp), np.zeros(lp.n), np.zeros(lp.m),
                            lp.m, lp.n, lp.m_eq, 1, device="meta")


def test_plain_sums_refuse_tensors_off_the_cpu():
    """The plain version's sums run on CPU tensors only (a CUDA
    index_add_ adds in no fixed order); the wrapper checks its operands."""
    _, lp = _lps("pon3", "energy")
    q, tau, sig, cols, rows, ub = solver._pdhg_ops(
        *_args(lp)[:6], lp.m, lp.n, lp.m_eq, "cpu")
    with pytest.raises(ValueError, match="CPU tensors only"):
        pdhg_coo._sums(q.to("meta"), rows, q)
    x = torch.zeros(lp.n)
    with pytest.raises(ValueError, match="length"):
        ops.pdhg_coo_burst(_t(_args(lp)[0])[:-1], tau, x, q, sig, ub,
                           x > 0, q > 0, cols, rows, x, q.clone(), iters=1)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.pdhg_coo_burst(_t(_args(lp)[0]).requires_grad_(), tau, x, q,
                           sig, ub, x > 0, q > 0, cols, rows, x, q.clone(),
                           iters=1)


def test_scale_knobs_require_pallas_as_in_the_reference():
    _, lp = _lps("pon3", "energy")
    for kw in (dict(shards=2), dict(precision="bf16")):
        with pytest.raises(ValueError) as got:
            solver.solve_lp(lp, backend="xla", device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            r_solver.solve_lp(_lps("pon3", "energy")[0], backend="xla",
                              **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown solver backend"):
        solver.solve_lp(lp, backend="cuda", device="cpu")
    with pytest.raises(SystemExit) as exc:
        sweep_main.main(["--device", "cpu", "--backend", "xla", "--mesh",
                         "2"])
    assert "backend='pallas'" in exc.value.code
    with pytest.raises(ValueError, match="unknown backend"):
        search.SearchConfig(backend="bogus", device="cpu").validate()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_convert_carries_backend(backend):
    """The reference's ServiceConfig, SearchConfig and SweepSpec keep
    their PDHG backend across packages (round trips through the port's
    own objects too)."""
    rcfg = r_service.ServiceConfig(iters=1000, backend=backend)
    cfg = convert.service_config_from_arrays(
        convert.service_config_to_arrays(rcfg), device="cpu")
    assert cfg.backend == backend and cfg.iters == 1000
    assert convert.service_config_from_arrays(
        convert.service_config_to_arrays(cfg), device="cpu") == cfg
    rs = r_optimize.SearchConfig(population=5, backend=backend)
    sc = convert.search_config_from_arrays(
        convert.search_config_to_arrays(rs), device="cpu")
    assert sc == search.SearchConfig(population=5, backend=backend,
                                     device="cpu")
    assert convert.search_config_from_arrays(
        convert.search_config_to_arrays(sc), device="cpu") == sc
    rsp = r_runner.SweepSpec(topos=("pon3",), seeds=(0,), backend=backend)
    sp = convert.sweep_spec_from_arrays(
        convert.sweep_spec_to_arrays(rsp), device="cpu")
    assert sp == runner.SweepSpec(topos=("pon3",), seeds=(0,),
                                  backend=backend, device="cpu")
    sp.validate()
    assert convert.sweep_spec_from_arrays(
        convert.sweep_spec_to_arrays(sp), device="cpu") == sp
