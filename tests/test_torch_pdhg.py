"""The plain PyTorch PDHG burst against the reference's Pallas kernel
(interpret mode on the CPU) and its pure-jnp oracle, and the port's
solve_lp against the reference's blocked-ELL solve_lp.

The CUDA kernel itself cannot run here (no card, no nvcc): chip_smoke.py
holds it against this plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solver as r_solver
from repro.core import timeslot as r_timeslot
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.core import solver, timeslot, topology, traffic
from repro_torch.kernels import ops, pdhg_spmv


def _burst_inputs(rng, m, n, m_eq, frozen):
    """numpy operands of one burst: a random operator with a few wide
    rows, preconditioners from its row/column sums, frozen masks."""
    nnz = 8 * m
    row = np.concatenate([rng.integers(0, m, nnz),
                          np.repeat(rng.integers(0, m, 2), 40)])
    col = rng.integers(0, n, len(row))
    val = rng.normal(size=len(row))
    op = pdhg_spmv.ell_pack(row, col, val, m, n)
    cs = np.zeros(n)
    np.add.at(cs, col, np.abs(val))
    rs = np.zeros(m)
    np.add.at(rs, row, np.abs(val))
    keep_n = np.zeros(op.n_pad, bool)
    keep_m = np.zeros(op.m_pad, bool)
    keep_n[:n] = rng.random(n) < frozen
    keep_m[:m] = rng.random(m) < frozen

    def padn(a):
        return np.pad(np.asarray(a, np.float32), (0, op.n_pad - n))

    def padm(a):
        return np.pad(np.asarray(a, np.float32), (0, op.m_pad - m))

    args = (padn(rng.normal(size=n)), padn(1.0 / np.maximum(cs, 1e-12)),
            padn(rng.uniform(0.5, 4.0, n)), padm(rng.normal(size=m)),
            padm(1.0 / np.maximum(rs, 1e-12)),
            np.pad(np.arange(m) >= m_eq, (0, op.m_pad - m),
                   constant_values=True),
            keep_n, keep_m, op.rows.idx, op.rows.val, op.cols.idx,
            op.cols.val, padn(rng.uniform(0.0, 1.0, n)),
            padm(rng.normal(size=m)))
    return op, args


CASES = [(41, 33, 20, 0.0), (40, 32, 16, 0.4), (9, 6, 4, 0.0),
         (200, 150, 90, 0.2)]


@pytest.mark.parametrize("iters", [0, 1, 200])
@pytest.mark.parametrize("m,n,m_eq,frozen", CASES)
def test_plain_burst_matches_reference(m, n, m_eq, frozen, iters):
    rng = np.random.default_rng(m + n)
    op, args = _burst_inputs(rng, m, n, m_eq, frozen)
    kw = dict(row_meta=op.rows.meta, col_meta=op.cols.meta, iters=iters)
    got = ops.pdhg_burst(*(torch.from_numpy(a) for a in args), **kw)
    jargs = tuple(jnp.asarray(a) for a in args)
    pallas = r_ops.pdhg_burst(*jargs, **kw, interpret=True)
    oracle = r_ref.pdhg_ell_burst_ref(*jargs, **kw)
    x_scale = max(float(np.abs(np.asarray(oracle[0])).max()), 1.0)
    for g, want in [(g, w) for ref in (pallas, oracle)
                    for g, w in zip(got, ref)]:
        g, want = g.numpy(), np.asarray(want)
        if iters <= 1:
            # only the order of each row's sum differs
            np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-6)
        else:
            # that difference compounds over the iterations
            np.testing.assert_allclose(g, want, atol=1e-4 * x_scale)
    # frozen coordinates held, padded slots pinned at zero
    x0, y0, keep_n, keep_m = args[12], args[13], args[6], args[7]
    assert np.array_equal(got[0].numpy()[keep_n], x0[keep_n])
    assert np.array_equal(got[1].numpy()[keep_m], y0[keep_m])
    assert np.all(got[0].numpy()[n:] == 0.0)
    assert np.all(got[1].numpy()[m:] == 0.0)
    assert np.all(got[2].numpy()[m:] == 0.0)


def test_spmv_matches_dense():
    rng = np.random.default_rng(7)
    m, n = 45, 31
    row = np.concatenate([rng.integers(0, m, 400),
                          np.repeat(rng.integers(0, m, 3), 40)])
    col = rng.integers(0, n, len(row))
    val = rng.normal(size=len(row))
    op = pdhg_spmv.ell_pack(row, col, val, m, n)
    K = np.zeros((m, n))
    np.add.at(K, (row, col), val)
    K = K.astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    g = pdhg_spmv.width_groups(op.rows.meta, "cpu")
    idx = torch.from_numpy(op.rows.idx)[g.perm]
    v = torch.from_numpy(op.rows.val)[g.perm]
    kx = pdhg_spmv.spmv_blocks(torch.from_numpy(np.pad(x, (0, op.n_pad - n))),
                               idx, v, g).numpy()
    np.testing.assert_allclose(kx[:m], K @ x, atol=1e-4, rtol=1e-5)
    assert np.all(kx[m:] == 0.0)


def _problems(topo_name, pat):
    tp, rt = topology.build(topo_name), r_topology.build(topo_name)
    cf = traffic.generate(tp, traffic.pattern("uniform", **pat), 0)
    rcf = r_traffic.generate(rt, r_traffic.pattern("uniform", **pat), 0)
    n = timeslot.suggest_n_slots(tp, cf)
    return (timeslot.ScheduleProblem(tp, cf, n_slots=n, path_slack=2),
            r_timeslot.ScheduleProblem(rt, rcf, n_slots=n, path_slack=2))


@pytest.mark.parametrize("topo_name,objective", [
    ("pon3", "time"), ("bcube", "energy"), ("dcell", "time")])
def test_solve_lp_matches_reference(topo_name, objective):
    p, rp = _problems(topo_name, dict(n_map=3, n_reduce=2, total_gbits=6.0))
    lp, _ = solver.build_routing_lp(p, objective)
    rlp, _ = r_solver.build_routing_lp(rp, objective)
    got = solver.solve_lp(lp, iters=2000, backend="pallas", device="cpu")
    want = r_solver.solve_lp(rlp, iters=2000, backend="pallas")
    np.testing.assert_allclose(got.x, want.x, atol=5e-3)
    # the same restart ladder: equal, or one rung apart when a residual
    # lands within fp noise of the tolerance
    rungs = [round(np.log2(r.iterations / 2000 + 1)) for r in (got, want)]
    assert abs(rungs[0] - rungs[1]) <= 1, (got.iterations, want.iterations)
    tol = 1e-4 * max(float(np.abs(lp.b).max()), 1.0)
    assert got.primal_residual <= tol or got.iterations == 2000 * 15


def test_solve_lp_warm_start_continues_trajectory():
    """A burst of 2k from zero equals k, then k more warm-started from
    the first result (x0/y0), up to the float32 round trip of the state
    (which is exact: the state is stored as float32)."""
    p, _ = _problems("spine-leaf", dict(n_map=3, n_reduce=2,
                                        total_gbits=6.0))
    lp, _ = solver.build_routing_lp(p, "energy")
    kw = dict(max_restarts=0, tol=0.0, device="cpu")
    whole = solver.solve_lp(lp, iters=300, backend="pallas", **kw)
    half = solver.solve_lp(lp, iters=150, backend="pallas", **kw)
    rest = solver.solve_lp(lp, iters=150, x0=half.x, y0=half.y,
                           backend="pallas", **kw)
    assert np.array_equal(rest.x, whole.x) and np.array_equal(rest.y, whole.y)
