"""The port's warm-start family against the JAX package.

One reference result is carried across by `convert.py`; the projection
(`project_warm_start`, with and without a flow map) and the stranded
volume are numpy in both packages and must be bitwise equal.  The warm
solves (`solve_fast_warm`, `solve_fast_group`) run through the burst
kernel's plain version (device="cpu") and are held to the reference's
blocked-ELL lowering (`backend="pallas"`, Pallas in interpret mode)
within 1e-4 relative; the port's stacked members to their own solo
solves.
"""
import numpy as np
import pytest
import torch

from repro.core import failures as r_failures
from repro.core import solver as r_solver
from repro.core import timeslot as r_timeslot
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro_torch import convert
from repro_torch.core import failures, solver, timeslot, topology, traffic
from repro_torch.kernels import ops

PORT = (topology, traffic, timeslot)
REF = (r_topology, r_traffic, r_timeslot)
LIGHT = dict(n_map=4, n_reduce=3, total_gbits=6.0)
METRIC_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these solves run thousands of tiny torch ops,
    which spinning thread pools slow down under parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def merged_problem(mods, seeds=(0, 1), topo_name="spine-leaf"):
    mod_topology, mod_traffic, mod_timeslot = mods
    topo = mod_topology.build(topo_name)
    pat = mod_traffic.pattern("uniform", **LIGHT)
    cf = mod_traffic.concat_coflows(
        [mod_traffic.generate(topo, pat, s) for s in seeds],
        topo.n_vertices)
    return mod_timeslot.ScheduleProblem(
        topo, cf, n_slots=mod_timeslot.suggest_n_slots(topo, cf),
        path_slack=2)


def sub_problem(mods, p, keep, scale=0.5):
    """Every `keep`-indexed flow of p with its size scaled, re-indexed."""
    _, mod_traffic, mod_timeslot = mods
    cf = p.coflow
    sub = mod_traffic.CoflowSet(cf.src[keep], cf.dst[keep],
                                scale * cf.size[keep], cf.n_vertices)
    return mod_timeslot.ScheduleProblem(
        p.topo, sub, n_slots=mod_timeslot.suggest_n_slots(p.topo, sub),
        path_slack=2)


@pytest.fixture(scope="module")
def healthy():
    """(reference problem, its pallas solve, port problem, the solve
    carried across)."""
    rp, p = merged_problem(REF), merged_problem(PORT)
    r = r_solver.solve_fast(rp, "energy", iters=3000, tol=2e-3,
                            backend="pallas")
    return rp, r, p, convert.fast_result_from_arrays(
        convert.fast_result_to_arrays(r))


def close_metrics(g, w, rtol=METRIC_RTOL) -> bool:
    return all(getattr(g.metrics, k) == pytest.approx(
        getattr(w.metrics, k), rel=rtol, abs=1e-9)
        for k in ("energy_j", "completion_s"))


def test_fast_result_carrier_round_trip(healthy):
    _, r, _, w = healthy
    assert isinstance(w, solver.FastPathResult)
    for name in ("schedule", "lp_x", "lp_y"):
        assert np.array_equal(getattr(w, name), getattr(r, name)), name
    assert w.lp_cscale == r.lp_cscale and w.iterations == r.iterations
    for name in ("kf", "ke", "kw"):
        assert np.array_equal(getattr(w.index, name),
                              getattr(r.index, name))
    assert w.index.eq_keys == [tuple(k) for k in r.index.eq_keys]
    assert w.index.ub_keys == [tuple(k) for k in r.index.ub_keys]
    assert len(w.paths) == len(r.paths)
    for a, b in zip(w.paths, r.paths):
        assert (a.flow, a.volume, a.tx_wavelength) == (b.flow, b.volume,
                                                       b.tx_wavelength)
        assert np.array_equal(a.triples, b.triples)
    assert w.metrics.energy_j == r.metrics.energy_j
    assert np.array_equal(w.metrics.served, r.metrics.served)
    again = convert.fast_result_from_arrays(
        convert.fast_result_to_arrays(w))
    assert np.array_equal(again.lp_x, w.lp_x)


@pytest.mark.parametrize("preset", ["link1", "switch", "brownout"])
def test_projection_and_stranded_volume_bitwise(healthy, preset):
    rp, r, p, w = healthy
    rdp = r_failures.degrade_problem(rp, r_failures.sample(rp.topo, preset,
                                                           2))
    dp = failures.degrade_problem(p, failures.sample(p.topo, preset, 2))
    for obj in ("energy", "time"):
        rlp, ridx = r_solver.build_routing_lp(rdp, obj)
        lp, idx = solver.build_routing_lp(dp, obj)
        want = r_solver.project_warm_start(r, rdp, rlp, ridx)
        got = solver.project_warm_start(w, dp, lp, idx)
        assert got[0].dtype == np.float64
        assert np.array_equal(got[0], want[0]) and np.array_equal(
            got[1], want[1]), obj
    assert np.array_equal(solver.stranded_volume(w, dp),
                          r_solver.stranded_volume(r, rdp))


def test_flow_map_projection_bitwise_and_conserving(healthy):
    rp, r, p, w = healthy
    keep = np.arange(0, p.coflow.n_flows, 2)
    rsub, sub = sub_problem(REF, rp, keep), sub_problem(PORT, p, keep)
    rlp, ridx = r_solver.build_routing_lp(rsub, "energy")
    lp, idx = solver.build_routing_lp(sub, "energy")
    x0, y0 = solver.project_warm_start(w, sub, lp, idx, flow_map=keep)
    rx0, ry0 = r_solver.project_warm_start(r, rsub, rlp, ridx,
                                           flow_map=keep)
    assert np.array_equal(x0, rx0) and np.array_equal(y0, ry0)
    assert np.array_equal(
        solver.stranded_volume(w, sub, flow_map=keep),
        r_solver.stranded_volume(r, rsub, flow_map=keep))
    K, W = len(idx.kf), p.topo.n_wavelengths
    F = sub.coflow.n_flows
    inj = x0[K:K + F * W].reshape(F, W).sum(axis=1)
    np.testing.assert_allclose(inj, sub.coflow.size, atol=1e-9)
    with pytest.raises(ValueError):
        solver.project_warm_start(w, sub, lp, idx,
                                  flow_map=np.zeros(3, np.int64))


def test_solve_fast_warm_matches_reference(healthy):
    rp, r, p, w = healthy
    keep = np.arange(0, p.coflow.n_flows, 2)
    rsub, sub = sub_problem(REF, rp, keep), sub_problem(PORT, p, keep)
    want = r_solver.solve_fast_warm(rsub, "energy", warm=r, flow_map=keep,
                                    iters=3000, tol=2e-3, backend="pallas")
    got = solver.solve_fast_warm(sub, "energy", warm=w, flow_map=keep,
                                 iters=3000, tol=2e-3, device="cpu")
    cold = solver.solve_fast_warm(sub, "energy", iters=3000, tol=2e-3,
                                  device="cpu")
    assert got.warm_started and want.warm_started and not cold.warm_started
    assert got.iterations == want.iterations
    assert close_metrics(got, want)
    assert got.metrics.feasible and got.remaining_gbits <= 1e-6
    assert got.iterations < cold.iterations


def test_solve_fast_warm_falls_back_cold_on_shape_change(healthy):
    _, _, p, w = healthy
    other = topology.build("pon3")
    cf = traffic.generate(other, traffic.pattern("uniform", **LIGHT), 0)
    p2 = timeslot.ScheduleProblem(
        other, cf, n_slots=timeslot.suggest_n_slots(other, cf),
        path_slack=2)
    r = solver.solve_fast_warm(p2, "energy", warm=w, iters=2000, tol=2e-3,
                               device="cpu")
    assert r.metrics.feasible and not r.warm_started
    # a projection that raises starts cold too (only the projection is
    # guarded): a flow map of the wrong length
    r2 = solver.solve_fast_warm(p, "energy", warm=w,
                                flow_map=np.zeros(3, np.int64), iters=2000,
                                tol=2e-3, device="cpu")
    assert not r2.warm_started and r2.metrics.feasible
    assert solver.solve_fast_warm(p, "energy", warm=w, iters=2000, tol=2e-3,
                                  device="cpu").warm_started


def test_solve_fast_group_matches_reference_and_solo(healthy):
    """Mixed objectives, one cold member and one zero-flow member: every
    member tracks the reference's group to 1e-4 and equals its own solo
    solve_fast_warm bitwise (stacked PDHG decouples over the blocks, and
    a member's rows sum in the same order stacked or alone); the
    zero-flow member never reaches the kernel's stack."""
    rp, r, p, w = healthy
    keep = np.arange(0, p.coflow.n_flows, 2)
    rsub, sub = sub_problem(REF, rp, keep), sub_problem(PORT, p, keep)
    rempty = r_timeslot.ScheduleProblem(
        rp.topo, r_traffic.empty_coflow(rp.topo.n_vertices), n_slots=2)
    empty = timeslot.ScheduleProblem(
        p.topo, traffic.empty_coflow(p.topo.n_vertices), n_slots=2)
    objs = ["energy", "time", "energy", "energy"]
    want = r_solver.solve_fast_group(
        [rsub, rp, rp, rempty], objs, warm=[r, r, None, r],
        flow_maps=[keep, None, None, None], iters=3000, tol=2e-3,
        backend="pallas")
    solver.reset_dispatch_stats()
    got = solver.solve_fast_group(
        [sub, p, p, empty], objs, warm=[w, w, None, w],
        flow_maps=[keep, None, None, None], iters=3000, tol=2e-3,
        device="cpu")
    assert [g.warm_started for g in got] == [x.warm_started for x in want]
    assert [g.warm_started for g in got] == [True, True, False, True]
    for g, x in zip(got, want):
        assert g.iterations == x.iterations
        assert close_metrics(g, x)
    assert got[3].iterations == 0 and got[3].schedule.shape[0] == 0
    for i, (q, o, ws, fm) in enumerate([(sub, "energy", w, keep),
                                        (p, "time", w, None),
                                        (p, "energy", None, None)]):
        solo = solver.solve_fast_warm(q, o, warm=ws, flow_map=fm,
                                      iters=3000, tol=2e-3, device="cpu")
        assert np.array_equal(solo.lp_x, got[i].lp_x), i
        assert np.array_equal(solo.schedule, got[i].schedule), i


def test_stacked_members_with_distinct_patterns_equal_solo(healthy):
    """A warm ensemble of members that each have their own degraded
    topology (their own sparsity pattern): each member's iterate equals
    its solo warm solve bitwise, and a member with no flows neither
    widens the stack nor reaches the kernel."""
    _, _, p, w = healthy
    members = [failures.degrade_problem(p, failures.sample(p.topo, pr, 0))
               for pr in ("link1", "switch", "degrade50")]
    zero = timeslot.ScheduleProblem(
        p.topo, traffic.empty_coflow(p.topo.n_vertices), n_slots=2)
    keys = {solver._structure_key(q, "energy") for q in members}
    assert len(keys) == len(members)
    solver.reset_dispatch_stats()
    group = solver.solve_fast_ensemble(members + [zero], "energy",
                                       warm=[w] * 4, iters=3000, tol=2e-3,
                                       device="cpu")
    # every dispatch stacks the flowing members only (a shape's last
    # field is its instance count)
    assert solver._DISPATCH_SHAPES
    assert all(shape[-1] <= len(members) for shape in solver._DISPATCH_SHAPES)
    for q, g in zip(members, group):
        solo = solver.solve_fast_ensemble([q], "energy", warm=[w],
                                          iters=3000, tol=2e-3,
                                          device="cpu")[0]
        assert np.array_equal(solo.lp_x, g.lp_x)
        assert np.array_equal(solo.lp_y, g.lp_y)
    assert group[-1].iterations == 0
    lp0, _ = solver.build_routing_lp(zero, "energy")
    assert lp0.m == 0 or lp0.n == 0


def test_warm_iterate_reaches_the_burst_as_fp32(healthy, monkeypatch):
    """The float64 projection is cast once to float32 for the burst, as a
    cold start's zeros are."""
    _, _, p, w = healthy
    lp, idx = solver.build_routing_lp(p, "energy")
    x0, y0 = solver.project_warm_start(w, p, lp, idx)
    seen = []
    real = ops.pdhg_adaptive

    def spy(*a, **kw):
        seen.append((a[10].clone(), a[11].clone()))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "pdhg_adaptive", spy)
    solver.solve_fast_warm(p, "energy", warm=w, iters=1000, device="cpu")
    x_in, y_in = seen[0]
    assert x_in.dtype == torch.float32
    assert np.array_equal(x_in.numpy()[:lp.n], x0.astype(np.float32))
    np.testing.assert_array_equal(
        y_in.numpy()[:lp.m], y0.astype(np.float32))
