"""The port's failure engine and degraded-fabric re-solves against the JAX
package.

`core.failures` is numpy in both packages, so scenarios, degraded
capacities, repairs, routability and degraded problems must be bitwise
equal on the same inputs.  The warm-started re-solves run through the
burst kernel's plain version (device="cpu") and are held to the
reference's blocked-ELL lowering (`backend="pallas"`, Pallas in
interpret mode) within 1e-4 relative, and to the reference's own gates
(warm == cold served, energy within 5%).
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
from repro_torch.core import verify

PRESETS = ["link1", "link3", "switch", "device", "degrade50", "brownout"]
TOPOS = ["fat-tree", "spine-leaf", "bcube", "dcell", "pon3", "pon5"]
PORT = (topology, traffic, timeslot)
REF = (r_topology, r_traffic, r_timeslot)
# metrics of a solve through the plain version against the reference's
# pallas lowering (the two differ in each row's summation order)
METRIC_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these solves run thousands of tiny torch ops,
    which spinning thread pools slow down under parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_problem(mods, name="spine-leaf", seed=2, total=8.0):
    mod_topology, mod_traffic, mod_timeslot = mods
    t = mod_topology.build(name)
    cf = mod_traffic.shuffle_traffic(t, total, n_map=4, n_reduce=3,
                                     seed=seed)
    return mod_timeslot.ScheduleProblem(
        t, cf, n_slots=mod_timeslot.suggest_n_slots(t, cf), path_slack=2)


def same_scenario(a, b) -> bool:
    return convert.scenario_to_arrays(a) == convert.scenario_to_arrays(b)


def same_problem(p, q) -> bool:
    a, b = convert.problem_to_arrays(p), convert.problem_to_arrays(q)
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
        else a[k] == b[k] for k in a)


def close_metrics(g, w, rtol=METRIC_RTOL) -> bool:
    return all(getattr(g.metrics, k) == pytest.approx(
        getattr(w.metrics, k), rel=rtol, abs=1e-9)
        for k in ("energy_j", "completion_s"))


# ---------------------------------------------------------------------------
# numpy: bitwise equal to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TOPOS)
def test_presets_bitwise_equal_reference(name):
    """sample/ensemble/apply/affected_rows/repair/compose on every preset
    of every paper topology, in both packages."""
    topo, rtopo = topology.build(name), r_topology.build(name)
    scens, rscens = [], []
    for preset in PRESETS:
        got = failures.ensemble(topo, preset, range(3))
        want = r_failures.ensemble(rtopo, preset, range(3))
        assert all(same_scenario(g, w) for g, w in zip(got, want)), preset
        for s, rs in zip(got, want):
            d, rd = failures.apply(topo, s), r_failures.apply(rtopo, rs)
            assert d.name == rd.name
            assert d.cap.tobytes() == rd.cap.tobytes(), preset
            assert np.array_equal(failures.affected_rows(topo, s),
                                  r_failures.affected_rows(rtopo, rs))
            assert (failures.degradation_ratio(topo, d)
                    == r_failures.degradation_ratio(rtopo, rd))
            back = failures.repair(d, s, topo)
            assert back.cap.tobytes() == topo.cap.tobytes()
            assert back.name == topo.name
        scens.append(got[0])
        rscens.append(want[0])
    c = failures.compose(scens)
    rc = r_failures.compose(rscens)
    assert same_scenario(c, rc)
    assert (failures.apply(topo, c).cap.tobytes()
            == r_failures.apply(rtopo, rc).cap.tobytes())
    assert failures.link_groups(topo) == r_failures.link_groups(rtopo)


@pytest.mark.parametrize("name", TOPOS)
def test_degrade_problem_and_routable_flows_bitwise(name):
    p, rp = small_problem(PORT, name), small_problem(REF, name)
    assert same_problem(p, rp)
    for preset in PRESETS:
        s = failures.sample(p.topo, preset, 1)
        rs = r_failures.sample(rp.topo, preset, 1)
        dp = failures.degrade_problem(p, s)
        rdp = r_failures.degrade_problem(rp, rs)
        assert same_problem(dp, rdp), preset
        assert np.array_equal(failures.routable_flows(dp),
                              r_failures.routable_flows(rdp)), preset


def test_scenario_carrier_round_trip():
    topo = r_topology.build("bcube")
    for preset in PRESETS:
        rs = r_failures.sample(topo, preset, 4)
        s = convert.scenario_from_arrays(convert.scenario_to_arrays(rs))
        assert isinstance(s, failures.FailureScenario)
        assert same_scenario(s, rs)
        assert (failures.apply(topology.build("bcube"), s).cap.tobytes()
                == r_failures.apply(topo, rs).cap.tobytes())


# ---------------------------------------------------------------------------
# the reference's own gates, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_degraded_schema_valid_and_repair_exact(preset):
    topo = topology.build("spine-leaf")
    scen = failures.sample(topo, preset, seed=3)
    d = failures.apply(topo, scen)
    np.testing.assert_array_equal(d.edges, topo.edges)
    assert (d.cap >= 0.0).all() and (d.cap <= topo.cap + 1e-12).all()
    assert 0.0 < failures.degradation_ratio(topo, d) <= 1.0
    d.validate()
    restored = failures.repair(d, scen, topo)
    assert restored.cap.tobytes() == topo.cap.tobytes()
    cf = traffic.shuffle_traffic(topo, 8.0, n_map=4, n_reduce=3, seed=2)
    n = timeslot.suggest_n_slots(topo, cf)
    p_h = timeslot.ScheduleProblem(topo, cf, n_slots=n, path_slack=2)
    p_r = timeslot.ScheduleProblem(restored, cf, n_slots=n, path_slack=2)
    assert (solver._structure_key(p_h, "energy")
            == solver._structure_key(p_r, "energy"))
    other = failures.apply(topo, failures.sample(topo, "switch", seed=5))
    if preset == "link1":
        with pytest.raises(ValueError, match="not apply"):
            failures.repair(other, scen, topo)


def test_degrade_problem_zeroes_unroutable_flows():
    p = small_problem(PORT, "spine-leaf")
    srv = int(p.coflow.src[0])
    e = int(np.flatnonzero(p.topo.edges[:, 0] == srv)[0])
    dst = int(p.topo.edges[e, 1])
    groups = failures.link_groups(p.topo)
    gid = next(i for i, g in enumerate(groups)
               if set(np.unique(p.topo.edges[list(g)])) == {srv, dst})
    dp = failures.degrade_problem(p, failures.cut_links(p.topo, [gid]))
    touched = (p.coflow.src == srv) | (p.coflow.dst == srv)
    assert (dp.coflow.size[touched] == 0.0).all()
    assert np.array_equal(dp.coflow.size[~touched], p.coflow.size[~touched])
    r = solver.solve_fast(dp, "energy", iters=2000, device="cpu")
    assert r.metrics.feasible
    assert r.metrics.served.sum() < p.coflow.total_gbits


# ---------------------------------------------------------------------------
# warm-started re-solves against the reference and against cold solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective", ["energy", "time"])
def test_resolve_incremental_matches_reference(objective):
    """One healthy reference solve carried across: the port's warm
    re-solve of the degraded instance tracks the reference's to 1e-4,
    serves what a cold solve serves and lands within the reference's 5%
    band of it."""
    rp = small_problem(REF)
    p = small_problem(PORT)
    r_healthy = r_solver.solve_fast(rp, objective, iters=2000,
                                    backend="pallas")
    healthy = convert.fast_result_from_arrays(
        convert.fast_result_to_arrays(r_healthy))
    rdp = r_failures.degrade_problem(rp, r_failures.sample(rp.topo,
                                                           "link1", 0))
    dp = failures.degrade_problem(p, failures.sample(p.topo, "link1", 0))
    want = r_solver.resolve_incremental(rdp, objective, r_healthy,
                                        iters=2000, backend="pallas")
    warm = solver.resolve_incremental(dp, objective, healthy, iters=2000,
                                      device="cpu")
    cold = solver.solve_fast(dp, objective, iters=2000, device="cpu")
    assert warm.iterations == want.iterations
    assert close_metrics(warm, want)
    verify.check_schedule(dp, warm.schedule).assert_ok("warm re-solve")
    assert warm.metrics.served.sum() == pytest.approx(
        cold.metrics.served.sum(), rel=1e-6)
    key = "energy_j" if objective == "energy" else "completion_s"
    assert getattr(warm.metrics, key) == pytest.approx(
        getattr(cold.metrics, key), rel=0.05)


def test_warm_ensemble_matches_reference_and_cold():
    rp, p = small_problem(REF, "bcube"), small_problem(PORT, "bcube")
    r_healthy = r_solver.solve_fast(rp, "energy", iters=2000,
                                    backend="pallas")
    healthy = convert.fast_result_from_arrays(
        convert.fast_result_to_arrays(r_healthy))
    rdprobs = [r_failures.degrade_problem(
        rp, r_failures.sample(rp.topo, "link1", s)) for s in range(3)]
    dprobs = [failures.degrade_problem(p, failures.sample(p.topo, "link1",
                                                          s))
              for s in range(3)]
    want = r_solver.solve_fast_ensemble(rdprobs, "energy",
                                        warm=[r_healthy] * 3, iters=2000,
                                        backend="pallas")
    warm = solver.solve_fast_ensemble(dprobs, "energy", warm=[healthy] * 3,
                                      iters=2000, device="cpu")
    cold = solver.solve_fast_ensemble(dprobs, "energy", iters=2000,
                                      device="cpu")
    for dp, c, w, r in zip(dprobs, cold, warm, want):
        assert w.iterations == r.iterations
        assert close_metrics(w, r)
        assert not w.warm_started and not r.warm_started
        verify.check_schedule(dp, w.schedule).assert_ok("warm member")
        assert c.metrics.feasible and w.metrics.feasible
        assert w.metrics.served.sum() == pytest.approx(
            c.metrics.served.sum(), rel=1e-6)
        assert w.metrics.energy_j == pytest.approx(c.metrics.energy_j,
                                                   rel=0.05)
    assert sum(w.iterations for w in warm) <= sum(c.iterations
                                                  for c in cold)


def test_noop_scenario_projection_is_lossless():
    p = small_problem(PORT)
    healthy = solver.solve_fast(p, "energy", iters=2000, device="cpu")
    lp, idx = solver.build_routing_lp(p, "energy")
    x0, y0 = solver.project_warm_start(healthy, p, lp, idx)
    np.testing.assert_allclose(y0, healthy.lp_y, atol=1e-12)
    F, W = p.coflow.n_flows, p.topo.n_wavelengths
    inj = x0[len(idx.kf):len(idx.kf) + F * W].reshape(F, W).sum(axis=1)
    per_flow = np.zeros(F)
    for pp in healthy.paths:
        per_flow[pp.flow] += pp.volume
    np.testing.assert_allclose(inj, np.minimum(per_flow, p.coflow.size),
                               atol=1e-9)
    assert sum(pp.volume for pp in healthy.paths) == pytest.approx(
        inj.sum(), abs=1e-9)


def test_warm_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    p = small_problem(PORT)
    healthy = solver.solve_fast(p, "energy", iters=200, device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        solver.resolve_incremental(p, "energy", healthy)
    with pytest.raises(RuntimeError, match="is_available"):
        solver.solve_fast_warm(p, "energy", warm=healthy)
    with pytest.raises(RuntimeError, match="is_available"):
        solver.solve_fast_ensemble([p], "energy", warm=[healthy])
    with pytest.raises(RuntimeError, match="is_available"):
        solver.solve_fast_group([p], "energy", warm=[healthy])
