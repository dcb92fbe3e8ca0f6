"""The port's routing LP and blocked-ELL layout are the reference's, bit
for bit, and the port's caches count hits on an unchanged structure."""
import numpy as np
import pytest

from repro.core import solver as r_solver
from repro.core import timeslot as r_timeslot
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro.kernels import pdhg_spmv as r_pdhg_spmv
from repro_torch.core import solver, timeslot, topology, traffic
from repro_torch.kernels import pdhg_spmv

PAT = dict(n_map=3, n_reduce=2, total_gbits=6.0)


def _problems(topo_name, **pkw):
    tp, rt = topology.build(topo_name), r_topology.build(topo_name)
    cf = traffic.generate(tp, traffic.pattern("uniform", **PAT), 0)
    rcf = r_traffic.generate(rt, r_traffic.pattern("uniform", **PAT), 0)
    n = timeslot.suggest_n_slots(tp, cf)
    return (timeslot.ScheduleProblem(tp, cf, n_slots=n, path_slack=2, **pkw),
            r_timeslot.ScheduleProblem(rt, rcf, n_slots=n, path_slack=2,
                                       **pkw))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("objective", ["energy", "time", "fair"])
@pytest.mark.parametrize("topo_name", list(r_topology.BUILDERS))
def test_routing_lp_bitwise(topo_name, objective):
    kw = {}
    if objective == "fair":
        kw["flow_weight"] = np.linspace(0.5, 2.0, PAT["n_map"]
                                        * PAT["n_reduce"])
    p, rp = _problems(topo_name, **kw)
    lp, idx = solver.build_routing_lp(p, objective, cache=False)
    rlp, ridx = r_solver.build_routing_lp(rp, objective, cache=False)
    for f in ("c", "row", "col", "val", "b", "h", "xmax"):
        _same(getattr(lp, f), getattr(rlp, f), f)
    for f in ("kf", "ke", "kw"):
        _same(getattr(idx, f), getattr(ridx, f), f)
    assert (idx.n_inj, idx.n_theta) == (ridx.n_inj, ridx.n_theta)
    assert idx.eq_keys == ridx.eq_keys and idx.ub_keys == ridx.ub_keys
    assert solver._structure_key(p, objective) == \
        r_solver._structure_key(rp, objective)


def _random_coo(rng, m, n, nnz, wide_rows):
    row = rng.integers(0, m, nnz)
    col = rng.integers(0, n, nnz)
    if wide_rows:
        row = np.concatenate([row, np.repeat(rng.integers(0, m, wide_rows),
                                             40)])
        col = np.concatenate([col, rng.integers(0, n, wide_rows * 40)])
    return row, col, rng.normal(size=len(row))


def _same_blocks(a, b):
    _same(a.idx, b.idx, "idx")
    _same(a.val, b.val, "val")
    assert (a.offsets, a.widths, a.bm, a.n_rows, a.n_rows_pad) == \
        (b.offsets, b.widths, b.bm, b.n_rows, b.n_rows_pad)


# the dense-reconstruction cases of tests/test_pdhg_kernels.py
@pytest.mark.parametrize("m,n,nnz,bm,align,wide", [
    (37, 29, 240, 8, 8, 0),        # ragged tail block
    (16, 16, 60, 8, 8, 2),         # wide rows force unequal block widths
    (5, 3, 9, 8, 8, 0),            # single (padded) block each side
    (64, 40, 300, 16, 32, 1),      # non-default block/alignment
    (12, 12, 0, 8, 8, 0),          # empty operator
])
def test_ell_layout_bitwise(m, n, nnz, bm, align, wide):
    rng = np.random.default_rng(m * 1000 + n)
    row, col, val = _random_coo(rng, m, n, nnz, wide)
    op = pdhg_spmv.ell_pack(row, col, val, m, n, bm=bm, align=align)
    rop = r_pdhg_spmv.ell_pack(row, col, val, m, n, bm=bm, align=align)
    _same_blocks(op.rows, rop.rows)
    _same_blocks(op.cols, rop.cols)
    assert (op.m_pad, op.n_pad) == (rop.m_pad, rop.n_pad)
    plan = pdhg_spmv.ell_plan(row, col, m, n, bm=bm, align=align)
    rplan = r_pdhg_spmv.ell_plan(row, col, m, n, bm=bm, align=align)
    val2 = rng.normal(size=len(row))
    a, b = pdhg_spmv.ell_fill(plan, val2), r_pdhg_spmv.ell_fill(rplan, val2)
    _same_blocks(a.rows, b.rows)
    _same_blocks(a.cols, b.cols)
    _same(plan.rows.order, rplan.rows.order, "order")
    _same(plan.cols.flat, rplan.cols.flat, "flat")
    # and the layout still reconstructs the dense operator
    K = np.zeros((m, n))
    np.add.at(K, (row, col), val2)
    dense = np.zeros((a.m_pad, n))
    for blk, (off, w) in enumerate(zip(a.rows.offsets, a.rows.widths)):
        idx = a.rows.idx[off:off + bm * w].reshape(bm, w)
        vals = a.rows.val[off:off + bm * w].reshape(bm, w)
        for i in range(bm):
            np.add.at(dense[blk * bm + i], idx[i], vals[i])
    np.testing.assert_allclose(dense[:m], K.astype(np.float32), atol=1e-6)
    assert np.all(dense[m:] == 0.0)


def test_pack_matches_reference_pack():
    """The solver's packing: tau/sig/q cast from float64 exactly as the
    reference's _pack_pallas does, padding pinned at zero."""
    p, rp = _problems("pon5")
    lp, _ = solver.build_routing_lp(p, "time")
    xmax = np.where(np.isfinite(lp.xmax), lp.xmax, 1e12)
    args = (lp.c, lp.row, lp.col, lp.val, lp.b, lp.h, xmax, lp.m_eq)
    op, vecs, ell = solver._pack_ell(*args, device="cpu")
    rop, rvecs, rell = r_solver._pack_pallas(*args)
    for a, b in zip(vecs + ell, rvecs + rell):
        _same(a.numpy(), np.asarray(b), "packed operand")
    assert op.n_pad > lp.n and float(vecs[2][lp.n:].abs().max()) == 0.0


def test_rebuild_and_resolve_hit_caches():
    p, _ = _problems("bcube")
    solver.reset_build_caches()
    stats = solver.build_cache_stats()
    lp1, _ = solver.build_routing_lp(p, "energy")
    lp2, _ = solver.build_routing_lp(p, "energy")
    assert (stats.structure_misses, stats.structure_hits) == (1, 1)
    assert lp1.row is lp2.row                   # shared skeleton
    r1 = solver.solve_lp(lp1, iters=20, max_restarts=0,
                         backend="pallas", device="cpu")
    r2 = solver.solve_lp(lp2, iters=20, max_restarts=0,
                         backend="pallas", device="cpu")
    assert (stats.ell_misses, stats.ell_hits) == (1, 1)
    assert np.array_equal(r1.x, r2.x) and np.array_equal(r1.y, r2.y)
    solver.reset_build_caches()
    assert stats.structure_hits == stats.ell_hits == 0
