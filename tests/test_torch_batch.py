"""The port's batched scheduler path on the CPU (the burst kernel's plain
version) against the reference's blocked-ELL batch (`backend="pallas"`,
Pallas in interpret mode), and against the port's own solo solves.

Block-diagonal PDHG decouples exactly over the instances, so a batch
reproduces each member's solo trajectory; the port and the reference
differ only in the order of each row's sum (fp32).
"""
import numpy as np
import pytest
import torch

from repro.core import solver as r_solver
from repro.core import timeslot as r_timeslot
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro_torch.core import solver, timeslot, topology, traffic, verify
from repro_torch.kernels import ops

# the port's iterate against the reference's after the same iterations:
# each row's fp32 sum is taken in another order, which compounds over a
# few thousand iterations to a few fp32 ulps of the iterate's scale
X_ATOL = 1e-4
# residuals (Gbit) near convergence are fp32 noise of that iterate; the
# bound is a tenth of the smallest default tolerance (1e-4 Gbit), so the
# ladder's convergence decisions cannot hinge on it
RES_ATOL = 1e-5
PAT = dict(n_map=4, n_reduce=3, total_gbits=8.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These solves run thousands of tiny torch ops; one intra-op thread
    keeps parallel test workers from oversubscribing the CPU with
    spinning thread pools, which slows such ops by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problems(mods, topo_name, seeds, pattern="uniform"):
    mod_topology, mod_traffic, mod_timeslot = mods
    topo = mod_topology.build(topo_name)
    cfs = mod_traffic.generate_batch(
        topo, mod_traffic.pattern(pattern, **PAT), seeds)
    return [mod_timeslot.ScheduleProblem(
        topo, cf, n_slots=mod_timeslot.suggest_n_slots(topo, cf),
        path_slack=2) for cf in cfs]


PORT = (topology, traffic, timeslot)
REF = (r_topology, r_traffic, r_timeslot)


def _lps(mods, solver_mod, topo_name, seeds, objective, pattern="uniform"):
    return [solver_mod.build_routing_lp(p, objective)[0]
            for p in _problems(mods, topo_name, seeds, pattern)]


def _empty_lps(objective):
    """A zero-flow instance in each package: a degenerate LP (no rows,
    and for the energy objective no variables)."""
    out = []
    for mod_topology, mod_traffic, mod_timeslot in (PORT, REF):
        topo = mod_topology.build("pon3")
        p = mod_timeslot.ScheduleProblem(
            topo, mod_traffic.empty_coflow(topo.n_vertices), n_slots=2)
        out.append(p)
    return (solver.build_routing_lp(out[0], objective)[0],
            r_solver.build_routing_lp(out[1], objective)[0])


def test_block_stack_and_residuals_bitwise_equal_reference():
    lps = (_lps(PORT, solver, "spine-leaf", [0, 1], "time")
           + _lps(PORT, solver, "pon3", [2], "energy"))
    rlps = (_lps(REF, r_solver, "spine-leaf", [0, 1], "time")
            + _lps(REF, r_solver, "pon3", [2], "energy"))
    bs, rbs = solver.block_stack(lps), r_solver.block_stack(rlps)
    for name in ("c", "row", "col", "val", "b", "h", "xmax"):
        a, b = getattr(bs.lp, name), getattr(rbs.lp, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("n_off", "eq_off", "ub_off"):
        assert np.array_equal(getattr(bs, name), getattr(rbs, name)), name
    x = np.random.default_rng(0).uniform(0, 1, bs.lp.n).astype(np.float32)
    got = solver._per_instance_residuals(bs, x)
    want = r_solver._per_instance_residuals(rbs, x)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("topo_name,objective", [("spine-leaf", "energy"),
                                                 ("pon3", "time")])
def test_solve_lp_batch_matches_reference_pallas(topo_name, objective,
                                                 adaptive):
    lps = _lps(PORT, solver, topo_name, [0, 1], objective)
    rlps = _lps(REF, r_solver, topo_name, [0, 1], objective)
    r_solver.reset_dispatch_stats()
    want = r_solver.solve_lp_batch(rlps, iters=1000, adaptive=adaptive,
                                   backend="pallas")
    r_stats = r_solver.dispatch_stats().snapshot()
    solver.reset_dispatch_stats()
    got = solver.solve_lp_batch(lps, iters=1000, adaptive=adaptive,
                                device="cpu")
    stats = solver.dispatch_stats().snapshot()
    for g, w in zip(got, want):
        assert g.iterations == w.iterations
        assert g.x.dtype == np.asarray(w.x).dtype
        np.testing.assert_allclose(g.x, w.x, atol=X_ATOL)
        assert abs(g.primal_residual - w.primal_residual) <= RES_ATOL
    assert (stats.dispatches, stats.shape_hits, stats.shape_misses) == (
        r_stats.dispatches, r_stats.shape_hits, r_stats.shape_misses)
    assert stats.dispatches >= 1


def test_dispatch_stats_count_repeated_shapes_like_reference():
    lps = _lps(PORT, solver, "pon3", [0, 1], "energy")
    rlps = _lps(REF, r_solver, "pon3", [0, 1], "energy")
    solver.reset_dispatch_stats()
    r_solver.reset_dispatch_stats()
    for _ in range(2):
        solver.solve_lp_batch(lps, iters=500, device="cpu")
        r_solver.solve_lp_batch(rlps, iters=500, backend="pallas")
    got, want = solver.dispatch_stats(), r_solver.dispatch_stats()
    assert (got.dispatches, got.shape_hits, got.shape_misses) == (
        want.dispatches, want.shape_hits, want.shape_misses)
    assert got.shape_hits >= 1


@pytest.mark.parametrize("objective", ["time", "energy"])
def test_fixed_batch_matches_own_solve_lp(objective):
    """adaptive=False is the solve_lp ladder per member: each member's x
    within 1e-6 of its solo solve (the bound of
    tests/test_solver_batch.py), with the same iterations.  The batch's
    residual is the float64 one of its fp32 iterate, solve_lp's the
    kernel's fp32 one."""
    lps = _lps(PORT, solver, "spine-leaf", [0, 1], objective, "skew")
    batch = solver.solve_lp_batch(lps, iters=1000, adaptive=False,
                                  device="cpu")
    for lp, b in zip(lps, batch):
        single = solver.solve_lp(lp, iters=1000, device="cpu")
        np.testing.assert_allclose(b.x, single.x, atol=1e-6)
        assert b.iterations == single.iterations
        assert abs(b.primal_residual - single.primal_residual) <= RES_ATOL


@pytest.mark.parametrize("adaptive", [False, True])
def test_mixed_shapes_and_degenerate_members(adaptive):
    lps = (_lps(PORT, solver, "spine-leaf", [0], "time")
           + [_empty_lps("energy")[0]]
           + _lps(PORT, solver, "pon3", [1], "time"))
    rlps = (_lps(REF, r_solver, "spine-leaf", [0], "time")
            + [_empty_lps("energy")[1]]
            + _lps(REF, r_solver, "pon3", [1], "time"))
    assert lps[1].n == 0 or lps[1].m == 0
    got = solver.solve_lp_batch(lps, iters=500, adaptive=adaptive,
                                device="cpu")
    want = r_solver.solve_lp_batch(rlps, iters=500, adaptive=adaptive,
                                   backend="pallas")
    for g, w, lp in zip(got, want, lps):
        assert g.x.shape == (lp.n,) and g.y.shape == (lp.m,)
        assert g.iterations == w.iterations
        np.testing.assert_allclose(g.x, w.x, atol=X_ATOL)
    assert got[1].iterations == 0 and got[1].primal_residual == 0.0


def test_duplicate_members_are_bitwise_equal():
    lp = _lps(PORT, solver, "pon3", [0], "energy")[0]
    batch = solver.solve_lp_batch([lp, lp, lp], iters=1000, device="cpu")
    for b in batch[1:]:
        assert np.array_equal(b.x, batch[0].x)
        assert np.array_equal(b.y, batch[0].y)
        assert b.iterations == batch[0].iterations


def _adaptive_operands(lps):
    """The stacked operands solve_lp_batch hands to ops.pdhg_adaptive."""
    bs = solver.block_stack(lps)
    g = bs.lp
    op, vecs, ell = solver._pack_ell(g.c, g.row, g.col, g.val, g.b, g.h,
                                     g.xmax, g.m_eq, torch.device("cpu"))
    B = len(lps)
    inst_n = np.full(op.n_pad, B)
    inst_n[:g.n] = np.repeat(np.arange(B), np.diff(bs.n_off))
    inst_m = np.full(op.m_pad, B)
    inst_m[:g.m] = np.concatenate([np.repeat(np.arange(B), np.diff(bs.eq_off)),
                                   np.repeat(np.arange(B), np.diff(bs.ub_off))])
    return bs, op, vecs, ell, torch.from_numpy(inst_n), torch.from_numpy(inst_m)


def test_adaptive_driver_freezes_a_member_with_infinite_tolerance():
    """A member with tol=inf freezes after its first chunk: it reports 1
    chunk used and its iterates equal a 1-chunk burst of it alone, while
    the others run on."""
    lps = _lps(PORT, solver, "pon3", [0, 1], "energy")
    bs, op, vecs, ell, inst_n, inst_m = _adaptive_operands(lps)
    x0 = torch.zeros(op.n_pad)
    y0 = torch.zeros(op.m_pad)
    chunk = 200
    x, y, res, used = ops.pdhg_adaptive(
        *vecs, *ell, x0, y0, torch.tensor([np.inf, 1e-9]), inst_n, inst_m,
        num_inst=2, row_meta=op.rows.meta, col_meta=op.cols.meta,
        chunk=chunk, max_chunks=4)
    assert used.tolist() == [1, 4]
    assert res.shape == (2,) and torch.isfinite(res).all()
    solo = solver.block_stack(lps[:1]).lp
    sop, svecs, sell = solver._pack_ell(solo.c, solo.row, solo.col, solo.val,
                                        solo.b, solo.h, solo.xmax, solo.m_eq,
                                        torch.device("cpu"))
    sx, _, _ = ops.pdhg_burst(
        *svecs, torch.zeros(sop.n_pad, dtype=torch.bool),
        torch.zeros(sop.m_pad, dtype=torch.bool), *sell,
        torch.zeros(sop.n_pad), torch.zeros(sop.m_pad),
        row_meta=sop.rows.meta, col_meta=sop.cols.meta, iters=chunk)
    n0 = int(bs.n_off[1])
    np.testing.assert_allclose(x[:n0].numpy(), sx[:n0].numpy(), atol=1e-6)


def test_adaptive_driver_compares_tolerances_in_fp32():
    """A tolerance given in float64 just below the float32 residual it
    rounds to freezes, as the reference's fp32 comparison does."""
    lps = _lps(PORT, solver, "pon3", [0], "energy")
    _, op, vecs, ell, inst_n, inst_m = _adaptive_operands(lps)
    kw = dict(num_inst=1, row_meta=op.rows.meta, col_meta=op.cols.meta,
              chunk=100, max_chunks=1)
    z = (torch.zeros(op.n_pad), torch.zeros(op.m_pad))
    _, _, res, _ = ops.pdhg_adaptive(*vecs, *ell, *z,
                                     torch.tensor([0.0]), inst_n, inst_m, **kw)
    r = float(res[0])
    below = np.nextafter(r, 0.0)           # float64, rounds up to r in fp32
    assert np.float32(below) == np.float32(r) and below < r
    _, _, _, used = ops.pdhg_adaptive(
        *vecs, *ell, *z, torch.tensor([below], dtype=torch.float64),
        inst_n, inst_m, **dict(kw, max_chunks=3))
    assert used.tolist() == [1]


def test_solve_fast_batch_certifies_and_matches_reference():
    probs = _problems(PORT, "spine-leaf", [0, 1])
    rprobs = _problems(REF, "spine-leaf", [0, 1])
    got = solver.solve_fast_batch(probs, "energy", iters=2000, tol=2e-3,
                                  device="cpu")
    want = r_solver.solve_fast_batch(rprobs, "energy", iters=2000, tol=2e-3,
                                     backend="pallas")
    for p, g, w in zip(probs, got, want):
        verify.check_schedule(p, g.schedule).assert_ok("batch member")
        assert g.remaining_gbits < 1e-6 and g.iterations == w.iterations
        for key in ("energy_j", "completion_s"):
            assert getattr(g.metrics, key) == pytest.approx(
                getattr(w.metrics, key), rel=1e-4)


def test_solve_fast_batch_requires_shared_topology():
    probs = (_problems(PORT, "spine-leaf", [0])
             + _problems(PORT, "pon3", [0]))
    with pytest.raises(ValueError, match="shared topology"):
        solver.solve_fast_batch(probs, "energy", device="cpu")


def test_warm_ensemble_is_not_ported_yet():
    """Named for the time the warm ensemble raised; it is ported now
    (tests/test_torch_failures.py holds it to the reference).  A member
    warm-started from its own finished solve certifies, serves what the
    cold member serves and spends no more iterations."""
    probs = _problems(PORT, "pon3", [0])
    cold = solver.solve_fast_ensemble(probs, "energy", iters=2000,
                                      tol=2e-3, device="cpu")
    warm = solver.solve_fast_ensemble(probs, "energy", warm=cold,
                                      iters=2000, tol=2e-3, device="cpu")
    verify.check_schedule(probs[0], warm[0].schedule).assert_ok("warm")
    assert warm[0].metrics.served.sum() == pytest.approx(
        cold[0].metrics.served.sum(), rel=1e-6)
    assert warm[0].iterations <= cold[0].iterations


def test_batch_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    probs = _problems(PORT, "pon3", [0])
    lp = solver.build_routing_lp(probs[0], "energy")[0]
    with pytest.raises(RuntimeError, match="is_available"):
        solver.solve_lp_batch([lp])
    with pytest.raises(RuntimeError, match="is_available"):
        solver.solve_fast_batch(probs)
    with pytest.raises(RuntimeError, match="is_available"):
        solver.solve_fast_ensemble(probs)
    with pytest.raises(NotImplementedError, match="shards"):
        solver.solve_lp_batch([lp], shards=2, device="cpu")
