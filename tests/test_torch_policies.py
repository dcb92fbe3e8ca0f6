"""The port's baseline policies against the JAX package.

`core.policies` is numpy in both packages apart from `fair-lp`: the
candidate path sets, every heuristic policy's packed schedule, its
certificate, its LP-layout primal vector and the shared `lp_cost`
functional must be bitwise the reference's on the same problem.  The
`policy/*` pins of tests/golden/metrics.json hold for the port with the
LP denominator solved by the burst kernel's plain version (device="cpu"):
metrics within RTOL, gaps within GAP_RTOL.  `fair-lp` runs PDHG and is
held to the reference's blocked-ELL lowering within 1e-4.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import failures as r_failures
from repro.core import policies as r_policies
from repro.core import timeslot as r_timeslot
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro_torch.core import (failures, policies, solver, timeslot, topology,
                              traffic)

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden"
                     / "metrics.json").read_text())
TOPOS = ["fat-tree", "spine-leaf", "bcube", "dcell", "pon3", "pon5"]
HEURISTICS = ["ecmp", "least-loaded", "scf", "fair"]
PATTERN = dict(n_map=4, n_reduce=3, total_gbits=8.0)
# tests/test_golden_metrics.py's envelopes
RTOL = 1e-4
GAP_RTOL = 5e-3
POLICY_GRID = [(topo, obj, pol) for topo in ("spine-leaf", "pon3")
               for obj in ("energy", "time")
               for pol in ("ecmp", "least-loaded", "scf")]
METRIC_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these solves run thousands of tiny torch ops,
    which spinning thread pools slow down under parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def golden_problem(mod_topology, mod_traffic, mod_timeslot, name,
                   placement="spread", seed=0):
    topo = mod_topology.build(name)
    cf = mod_traffic.generate(topo, mod_traffic.pattern(
        "uniform", placement=placement, **PATTERN), seed)
    return mod_timeslot.ScheduleProblem(
        topo, cf, n_slots=mod_timeslot.suggest_n_slots(topo, cf),
        path_slack=2)


def both(name, **kw):
    return (golden_problem(topology, traffic, timeslot, name, **kw),
            golden_problem(r_topology, r_traffic, r_timeslot, name, **kw))


def assert_results_equal(got, want):
    assert np.array_equal(got.schedule, want.schedule)
    for f in ("energy_j", "completion_s", "fairness_term", "feasible",
              "max_violation"):
        assert getattr(got.metrics, f) == getattr(want.metrics, f), f
    assert np.array_equal(got.metrics.served, want.metrics.served)
    assert got.lp_lower_bound == want.lp_lower_bound
    assert got.remaining_gbits == want.remaining_gbits
    assert np.array_equal(got.lp_x, want.lp_x)
    assert [(fp.flow, fp.triples.tolist(), fp.volume, fp.tx_wavelength)
            for fp in got.paths] == [
        (fp.flow, fp.triples.tolist(), fp.volume, fp.tx_wavelength)
        for fp in want.paths]
    assert got.certificate.ok == want.certificate.ok
    assert got.certificate.residuals == want.certificate.residuals


# ---------------------------------------------------------------------------
# numpy: bitwise the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TOPOS)
def test_path_sets_bitwise(name):
    for placement in ("spread", "packed"):
        p, rp = both(name, placement=placement)
        for k in (1, policies.DEFAULT_K_PATHS):
            idx, sets = policies.path_sets(p, k)
            ridx, rsets = r_policies.path_sets(rp, k)
            for f in ("kf", "ke", "kw"):
                assert np.array_equal(getattr(idx, f), getattr(ridx, f))
            assert (idx.n_inj, idx.n_theta) == (ridx.n_inj, ridx.n_theta)
            assert [[(fp.flow, fp.triples.tolist(), fp.volume,
                      fp.tx_wavelength) for fp in s] for s in sets] == [
                [(fp.flow, fp.triples.tolist(), fp.volume,
                  fp.tx_wavelength) for fp in s] for s in rsets]
            assert all(1 <= len(s) <= k for s in sets)


def test_path_sets_memo_is_per_problem_and_k():
    p, _ = both("spine-leaf")
    idx, sets = policies.path_sets(p)
    assert policies.path_sets(p)[1] is sets          # memoised
    assert policies.path_sets(p, 1)[1] is not sets   # another k rebuilds
    q, _ = both("spine-leaf")
    assert policies.path_sets(q)[1] is not sets      # another instance


@pytest.mark.parametrize("pol", HEURISTICS)
@pytest.mark.parametrize("name", TOPOS)
def test_heuristic_policies_bitwise(name, pol):
    for objective in ("energy", "time"):
        p, rp = both(name)
        got = policies.get(pol).solve(p, objective, device="cpu")
        want = r_policies.get(pol).solve(rp, objective)
        assert_results_equal(got, want)
        assert got.certificate.ok and got.remaining_gbits <= 1e-6


@pytest.mark.parametrize("pol", HEURISTICS)
def test_heuristics_skip_flows_a_failure_cut(pol):
    """A degraded problem (core.failures.degrade_problem) zeroes the
    demand of flows whose endpoints the failure disconnected; the
    policies skip them exactly as the reference's do.  The path sets
    memoised on the healthy problem do not reach the degraded one: it
    is a fresh instance, as every chaos epoch's problem is."""
    p, rp = both("spine-leaf")
    policies.path_sets(p)
    scen = failures.sample(p.topo, "switch", 1)
    rscen = r_failures.sample(rp.topo, "switch", 1)
    dp = failures.degrade_problem(p, scen)
    assert getattr(dp, "_path_sets_cache", None) is None
    rdp = r_failures.degrade_problem(rp, rscen)
    assert np.array_equal(dp.coflow.size, rdp.coflow.size)
    assert_results_equal(policies.get(pol).solve(dp, "energy"),
                         r_policies.get(pol).solve(rdp, "energy"))


def test_lp_cost_bitwise():
    p, rp = both("pon3")
    x = np.random.default_rng(0).uniform(0.0, 0.5, p.shape_x)
    for objective in ("energy", "time", "fair"):
        assert (policies.lp_cost(p, objective, x)
                == r_policies.lp_cost(rp, objective, x))
    w = np.linspace(0.5, 2.0, p.coflow.n_flows)
    pw = timeslot.ScheduleProblem(p.topo, p.coflow, n_slots=p.n_slots,
                                  path_slack=2, flow_weight=w)
    rpw = r_timeslot.ScheduleProblem(rp.topo, rp.coflow, n_slots=rp.n_slots,
                                     path_slack=2, flow_weight=w)
    assert (policies.lp_cost(pw, "fair", x)
            == r_policies.lp_cost(rpw, "fair", x))


def test_strict_priority_pack_honours_release_slots():
    p, rp = both("pon3")
    rel = np.arange(p.coflow.n_flows) % 3
    p = timeslot.ScheduleProblem(p.topo, p.coflow, n_slots=p.n_slots + 2,
                                 path_slack=2, release_slot=rel)
    rp = r_timeslot.ScheduleProblem(rp.topo, rp.coflow,
                                    n_slots=rp.n_slots + 2, path_slack=2,
                                    release_slot=rel)
    got = policies.get("scf").solve(p, "time")
    assert_results_equal(got, r_policies.get("scf").solve(rp, "time"))
    first = np.argmax(got.schedule.sum(axis=(1, 2)) > 0, axis=1)
    assert (first >= rel).all()


def test_unknown_policy_names_the_known_ones():
    with pytest.raises(KeyError, match="known: ecmp, fair, fair-lp"):
        policies.get("nope")
    assert list(policies.POLICIES) == list(r_policies.POLICIES)


def test_ecmp_shares_the_references_demand_scaling_seed():
    """tests/test_properties.py::test_demand_scaling_metamorphic_hyp
    fails on the reference at seed 1469957635: after every demand is
    scaled by k, ECMP leaves 5.886 Gbit unserved.  The port's ECMP takes
    the same routes and packs the same schedules bit for bit, so it
    shares the fault (ROADMAP queue 3)."""
    def draw(mod_topology, mod_traffic, mod_timeslot, seed=1469957635):
        rng = np.random.default_rng(seed)
        k = float(rng.uniform(2.0, 4.0))
        topo = mod_topology.build(str(rng.choice(("spine-leaf", "pon3"))))
        pat = mod_traffic.TrafficPattern(
            "prop", placement=str(rng.choice(mod_traffic.PLACEMENTS)),
            skew=str(rng.choice(mod_traffic.SKEWS)),
            n_map=int(rng.integers(2, 5)), n_reduce=int(rng.integers(2, 4)),
            total_gbits=float(rng.uniform(2.0, 10.0)))
        cf = mod_traffic.generate(topo, pat, int(rng.integers(0, 2**31 - 1)))
        cfk = mod_traffic.CoflowSet(cf.src, cf.dst, cf.size * k,
                                    cf.n_vertices)
        return [mod_timeslot.ScheduleProblem(
            topo, c, n_slots=mod_timeslot.suggest_n_slots(topo, c),
            path_slack=2) for c in (cf, cfk)]

    port = draw(topology, traffic, timeslot)
    ref = draw(r_topology, r_traffic, r_timeslot)
    for p, rp in zip(port, ref):
        assert_results_equal(policies.get("ecmp").solve(p, "time"),
                             r_policies.get("ecmp").solve(rp, "time"))
    unscaled = policies.get("ecmp").solve(port[0], "time")
    scaled = policies.get("ecmp").solve(port[1], "time")
    assert port[0].topo.name == "pon3"
    assert unscaled.remaining_gbits == 0.0
    assert scaled.remaining_gbits == pytest.approx(5.886225082009876,
                                                   rel=1e-12)


# ---------------------------------------------------------------------------
# the pinned optimal-vs-practical grid, and the LP policy
# ---------------------------------------------------------------------------

_LP = {}


def lp_for_gap(name, objective):
    if (name, objective) not in _LP:
        p, _ = both(name)
        _LP[name, objective] = (p, solver.solve_fast(p, objective,
                                                     backend="pallas",
                                                     device="cpu"))
    return _LP[name, objective]


@pytest.mark.parametrize("name,objective,pol", POLICY_GRID)
def test_golden_policy_gaps(name, objective, pol):
    want = GOLDEN[f"policy/{name}/min-{objective}/{pol}/seed0"]
    p_lp, lp = lp_for_gap(name, objective)
    p, _ = both(name)
    r = policies.get(pol).solve(p, objective, device="cpu")
    r.certificate.assert_ok(f"{pol}/{name}/min-{objective}")
    gap = policies.gap_vs_lp(objective, p, r.schedule, p_lp, lp)
    assert r.metrics.feasible and want["feasible"]
    assert gap >= 1.0 - 1e-4
    np.testing.assert_allclose(gap, want["gap_vs_lp"], rtol=GAP_RTOL)
    for key in ("energy_j", "completion_s"):
        np.testing.assert_allclose(getattr(r.metrics, key), want[key],
                                   rtol=RTOL, atol=1e-9)


def test_fair_lp_matches_reference_pallas():
    """The one PDHG policy: weighted max-min fairness on pon3, through
    the burst kernel's plain version, against the reference's blocked-ELL
    lowering (Pallas in interpret mode): metrics within 1e-4, both
    certified; with uniform weights it is the energy solve bit for bit."""
    p, rp = both("pon3")
    w = np.linspace(0.5, 2.0, p.coflow.n_flows)
    pw = timeslot.ScheduleProblem(p.topo, p.coflow, n_slots=p.n_slots,
                                  path_slack=2, flow_weight=w)
    rpw = r_timeslot.ScheduleProblem(rp.topo, rp.coflow, n_slots=rp.n_slots,
                                     path_slack=2, flow_weight=w)
    got = policies.get("fair-lp").solve(pw, "energy",
                                        backend="pallas", device="cpu")
    want = r_policies.get("fair-lp").solve(rpw, "energy", backend="pallas")
    assert got.certificate.ok and want.certificate.ok
    for key in ("energy_j", "completion_s", "fairness_term"):
        np.testing.assert_allclose(getattr(got.metrics, key),
                                   getattr(want.metrics, key),
                                   rtol=METRIC_RTOL, atol=1e-9)
    uniform = policies.get("fair-lp").solve(p, "energy",
                                            backend="pallas", device="cpu")
    energy = solver.solve_fast(p, "energy", backend="pallas", device="cpu")
    assert np.array_equal(uniform.schedule, energy.schedule)


def test_fair_lp_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    p, _ = both("pon3")
    with pytest.raises(RuntimeError, match="is_available"):
        policies.get("fair-lp").solve(p, "energy", backend="pallas")
