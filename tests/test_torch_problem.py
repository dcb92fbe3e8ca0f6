"""The port's problem model is the reference's, bit for bit.

Topologies, generated co-flow sets and placements, exact `evaluate`
metrics and `check_schedule` verdicts are numpy in both packages and must
agree exactly on equal inputs; `convert` carries a problem across.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import solver as r_solver
from repro.core import timeslot as r_timeslot
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro.core import verify as r_verify
from repro_torch import convert
from repro_torch.core import timeslot, topology, traffic, verify

TOPO_CASES = [(name, {}) for name in r_topology.BUILDERS] + [
    ("fat-tree", dict(k=8)), ("dcell-multi", dict(n=3, levels=2)),
    ("pon-multicell", dict(n_cells=3))]


def _assert_topo_equal(a, b):
    assert a.name == b.name
    assert [dataclasses.astuple(d) for d in a.devices] == \
        [dataclasses.astuple(d) for d in b.devices]
    for field in ("edges", "cap"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes(), field
    for field in ("n_wavelengths", "slot_duration", "task_servers",
                  "server_relay", "one_wavelength_tx", "awgr_in_ports",
                  "switch_sigma"):
        assert getattr(a, field) == getattr(b, field), field


@pytest.mark.parametrize("name,kw", TOPO_CASES,
                         ids=[f"{n}{kw or ''}" for n, kw in TOPO_CASES])
def test_topology_bitwise(name, kw):
    _assert_topo_equal(topology.build(name, **kw),
                       r_topology.build(name, **kw))


def _assert_coflow_equal(a, b):
    assert a.n_vertices == b.n_vertices
    for field in ("src", "dst", "size"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field


@pytest.mark.parametrize("scheme", r_traffic.RNG_SCHEMES)
@pytest.mark.parametrize("pat", sorted(r_traffic.PATTERNS))
@pytest.mark.parametrize("topo_name", ["spine-leaf", "pon3", "dcell"])
def test_traffic_bitwise(topo_name, pat, scheme):
    tp, rt = topology.build(topo_name), r_topology.build(topo_name)
    pp = traffic.pattern(pat, n_map=5, n_reduce=4, total_gbits=9.0)
    rp = r_traffic.pattern(pat, n_map=5, n_reduce=4, total_gbits=9.0)
    seeds = [0, 1, 7, 123456]
    for seed in seeds:
        _assert_coflow_equal(traffic.generate(tp, pp, seed, rng_scheme=scheme),
                             r_traffic.generate(rt, rp, seed,
                                                rng_scheme=scheme))
        pl = traffic.sample_placement(
            tp, pp, traffic._traffic_rng(seed, scheme))
        rpl = r_traffic.sample_placement(
            rt, rp, r_traffic._traffic_rng(seed, scheme))
        assert pl.key() == rpl.key()
    for a, b in zip(traffic.generate_batch(tp, pp, seeds, rng_scheme=scheme),
                    r_traffic.generate_batch(rt, rp, seeds,
                                             rng_scheme=scheme)):
        _assert_coflow_equal(a, b)


def test_shuffle_traffic_and_helpers_bitwise():
    tp, rt = topology.build("bcube"), r_topology.build("bcube")
    _assert_coflow_equal(traffic.shuffle_traffic(tp, 12.0, skew=True, seed=3),
                         r_traffic.shuffle_traffic(rt, 12.0, skew=True,
                                                   seed=3))
    a = traffic.custom_coflow([0, 1], [2, 3], [1.5, 2.5], tp.n_vertices)
    b = r_traffic.custom_coflow([0, 1], [2, 3], [1.5, 2.5], rt.n_vertices)
    _assert_coflow_equal(a, b)
    _assert_coflow_equal(
        traffic.concat_coflows([a, traffic.empty_coflow(tp.n_vertices), a],
                               tp.n_vertices),
        r_traffic.concat_coflows([b, r_traffic.empty_coflow(rt.n_vertices),
                                  b], rt.n_vertices))
    with pytest.raises(ValueError, match="out of range"):
        traffic.custom_coflow([0], [999], [1.0], tp.n_vertices)


def _problems(topo_name, seed=0, **pkw):
    pat = dict(n_map=4, n_reduce=3, total_gbits=8.0)
    tp, rt = topology.build(topo_name), r_topology.build(topo_name)
    cf = traffic.generate(tp, traffic.pattern("uniform", **pat), seed)
    rcf = r_traffic.generate(rt, r_traffic.pattern("uniform", **pat), seed)
    n = timeslot.suggest_n_slots(tp, cf)
    assert n == r_timeslot.suggest_n_slots(rt, rcf)
    return (timeslot.ScheduleProblem(tp, cf, n_slots=n, **pkw),
            r_timeslot.ScheduleProblem(rt, rcf, n_slots=n, **pkw))


EVAL_CASES = [("spine-leaf", "energy"), ("pon3", "time"), ("bcube", "time")]


@pytest.fixture(scope="module")
def ref_schedules():
    """Reference fast-path schedules (one solve per case, shared)."""
    out = {}
    for name, obj in EVAL_CASES:
        _, rp = _problems(name, path_slack=2)
        out[name, obj] = r_solver.solve_fast(rp, obj, iters=2000).schedule
    return out


def _assert_metrics_equal(a, b):
    for field in ("energy_j", "completion_s", "fairness_term", "feasible",
                  "max_violation"):
        assert getattr(a, field) == getattr(b, field), field
    for field in ("psi", "active_devices", "served"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field


@pytest.mark.parametrize("name,obj", EVAL_CASES)
def test_evaluate_and_certificate_bitwise(ref_schedules, name, obj):
    p, rp = _problems(name, path_slack=2)
    x = ref_schedules[name, obj]
    rng = np.random.default_rng(5)
    # the reference's own schedule, and a perturbed (infeasible) copy
    for sched in (x, x * (1.0 + 0.05 * rng.random(x.shape))):
        _assert_metrics_equal(timeslot.evaluate(p, sched),
                              r_timeslot.evaluate(rp, sched))
        c, rc = verify.check_schedule(p, sched), r_verify.check_schedule(
            rp, sched)
        assert c.residuals == rc.residuals and c.ok == rc.ok
        assert c.summary() == rc.summary()
    assert verify.check_schedule(p, x).ok


def test_problem_derived_arrays_and_prefix_energy_bitwise(ref_schedules):
    p, rp = _problems("pon3", path_slack=2, release_slot=np.array(
        [0, 1] * 6), flow_weight=np.linspace(1.0, 2.0, 12))
    for field in ("e_src", "e_dst", "is_server", "is_switch", "p_max", "eps",
                  "sigma", "flow_edge_mask", "edge_w_ok", "flow_weight"):
        assert np.array_equal(getattr(p, field), getattr(rp, field)), field
    x = ref_schedules["pon3", "time"]
    for t_end in (1, x.shape[-1]):
        assert timeslot.prefix_energy(p, x, t_end) == \
            r_timeslot.prefix_energy(rp, x, t_end)
    q, rq = timeslot.rehorizon(p, 9), r_timeslot.rehorizon(rp, 9)
    assert q.n_slots == rq.n_slots == 9
    assert q.flow_edge_mask is p.flow_edge_mask


@pytest.mark.parametrize("topo_name", ["pon3", "dcell"])
def test_convert_round_trip(topo_name):
    p, rp = _problems(topo_name, path_slack=2,
                      flow_weight=np.arange(1.0, 13.0))
    d = convert.problem_to_arrays(p)
    q = convert.problem_from_arrays(d)
    _assert_topo_equal(q.topo, p.topo)
    _assert_coflow_equal(q.coflow, p.coflow)
    d2 = convert.problem_to_arrays(q)
    assert d2.keys() == d.keys()
    for k in d:
        if isinstance(d[k], np.ndarray):
            assert d[k].dtype == d2[k].dtype and np.array_equal(d[k], d2[k])
        else:
            assert d[k] == d2[k], k
    # a reference-built problem crosses over unchanged
    r = convert.problem_from_arrays(convert.problem_to_arrays(rp))
    for field in ("flow_edge_mask", "edge_w_ok", "sigma", "flow_weight"):
        assert np.array_equal(getattr(r, field), getattr(rp, field)), field
    assert (r.n_slots, r.rho, r.q_weight, r.path_slack) == \
        (rp.n_slots, rp.rho, rp.q_weight, rp.path_slack)
