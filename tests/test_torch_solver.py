"""The port's solve_fast, run on the CPU through the kernel's plain
version, against the reference's solve_fast and the committed golden
pins; every schedule carries an `ok` certificate.

The reference runs its default "xla" backend here, the one the golden
pins come from; tests/test_pdhg_kernels.py holds its "pallas" backend
(the port's lowering) to the same metrics within 1e-4, and
tests/test_torch_pdhg.py holds the port's solve_lp to "pallas"."""
import functools
import json
import pathlib

import numpy as np
import pytest

from repro.core import failures as r_failures
from repro.core import solver as r_solver
from repro.core import timeslot as r_timeslot
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro_torch import convert
from repro_torch.core import solver, timeslot, topology, traffic, verify

GOLDEN = pathlib.Path(__file__).parent / "golden" / "metrics.json"
RTOL = 1e-4
# the pattern of tests/test_pdhg_kernels.py::
# test_backend_equivalence_all_topologies
PAT = dict(n_map=3, n_reduce=2, total_gbits=6.0)
ITERS = 2000


def _problem(mod_topology, mod_traffic, mod_timeslot, topo_name, pat):
    topo = mod_topology.build(topo_name)
    cf = mod_traffic.generate_batch(
        topo, mod_traffic.pattern("uniform", **pat), [0])[0]
    return mod_timeslot.ScheduleProblem(
        topo, cf, n_slots=mod_timeslot.suggest_n_slots(topo, cf),
        path_slack=2)


@functools.lru_cache(maxsize=None)
def _reference(topo_name, objective):
    rp = _problem(r_topology, r_traffic, r_timeslot, topo_name, PAT)
    return r_solver.solve_fast(rp, objective, iters=ITERS)


def _assert_metrics_close(got, want, what):
    for key in ("energy_j", "completion_s", "fairness_term"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   rtol=RTOL, atol=1e-9,
                                   err_msg=f"{what} {key}")
    np.testing.assert_allclose(got.served, want.served, rtol=RTOL,
                               atol=1e-9, err_msg=f"{what} served")


@pytest.mark.parametrize("objective", ["energy", "time"])
@pytest.mark.parametrize("topo_name", list(r_topology.BUILDERS))
def test_solve_fast_matches_reference(topo_name, objective):
    p = _problem(topology, traffic, timeslot, topo_name, PAT)
    got = solver.solve_fast(p, objective, iters=ITERS,
                            backend="pallas", device="cpu")
    want = _reference(topo_name, objective)
    verify.check_schedule(p, got.schedule).assert_ok(
        f"{topo_name}/{objective}")
    assert got.metrics.feasible and got.remaining_gbits < 1e-6
    _assert_metrics_close(got.metrics, want.metrics,
                          f"{topo_name}/{objective}")
    assert got.schedule.shape == want.schedule.shape
    assert got.index.eq_keys == want.index.eq_keys


@pytest.mark.parametrize("objective", ["energy", "time"])
@pytest.mark.parametrize("topo_name", ["spine-leaf", "pon3"])
def test_golden_metrics_hold(topo_name, objective):
    want = json.loads(GOLDEN.read_text())[
        f"{topo_name}/min-{objective}/seed0"]
    p = _problem(topology, traffic, timeslot, topo_name,
                 dict(n_map=4, n_reduce=3, total_gbits=8.0))
    r = solver.solve_fast(p, objective, backend="pallas", device="cpu")
    verify.check_schedule(p, r.schedule).assert_ok(
        f"{topo_name}/min-{objective}")
    got = {"energy_j": r.metrics.energy_j,
           "completion_s": r.metrics.completion_s,
           "fairness_term": r.metrics.fairness_term,
           "served_gbits": float(r.metrics.served.sum())}
    assert r.metrics.feasible and want["feasible"]
    for key, value in got.items():
        np.testing.assert_allclose(value, want[key], rtol=RTOL, atol=1e-9,
                                   err_msg=f"{topo_name}/{objective} {key}")


@pytest.mark.parametrize("topo_name,scenario", [
    ("spine-leaf", lambda t: r_failures.fail_device(t, "spine0")),
    ("pon5", lambda t: r_failures.degrade(t, 0.5)),
])
def test_degraded_reference_problem_via_convert(topo_name, scenario):
    """A degraded problem the port cannot build yet (repro.core.failures)
    is built by the reference, handed over as arrays, and solved to the
    reference's metrics."""
    rp = _problem(r_topology, r_traffic, r_timeslot, topo_name, PAT)
    rdeg = r_failures.degrade_problem(rp, scenario(rp.topo))
    assert rdeg.topo.cap.sum() < rp.topo.cap.sum()
    p = convert.problem_from_arrays(convert.problem_to_arrays(rdeg))
    for objective in ("energy", "time"):
        got = solver.solve_fast(p, objective, iters=ITERS,
                                backend="pallas", device="cpu")
        want = r_solver.solve_fast(rdeg, objective, iters=ITERS)
        verify.check_schedule(p, got.schedule).assert_ok(
            f"degraded {topo_name}/{objective}")
        _assert_metrics_close(got.metrics, want.metrics,
                              f"degraded {topo_name}/{objective}")


def test_empty_coflow_solves_trivially():
    topo = topology.build("pon3")
    p = timeslot.ScheduleProblem(topo, traffic.empty_coflow(topo.n_vertices),
                                 n_slots=3)
    for objective in ("energy", "time"):
        r = solver.solve_fast(p, objective, backend="pallas", device="cpu")
        assert r.iterations == 0 and not r.schedule.any()
        assert r.metrics.feasible and r.metrics.energy_j == 0.0


def test_solve_fast_is_repeatable():
    p = _problem(topology, traffic, timeslot, "dcell", PAT)
    a = solver.solve_fast(p, "time", iters=ITERS,
                          backend="pallas", device="cpu")
    b = solver.solve_fast(p, "time", iters=ITERS,
                          backend="pallas", device="cpu")
    assert np.array_equal(a.lp_x, b.lp_x) and np.array_equal(a.lp_y, b.lp_y)
    assert np.array_equal(a.schedule, b.schedule)
