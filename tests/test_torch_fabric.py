"""The port's rule-based schedules, wavelength MILP and collective slot
plans against the JAX package.

`core.heuristics` and `core.wavelength` are numpy (and scipy) in both
packages: their schedules and wirings must be bitwise equal.
`core.fabric.plan_collectives` runs the port's `solve_fast` through the
burst kernel's plain version (device="cpu") and is held to the
reference's blocked-ELL lowering (`backend="pallas"`, Pallas in
interpret mode, whose `solve_fast` the reference's plan calls through its
default backend) within 1e-4, and to the reference's own gates.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import fabric as r_fabric
from repro.core import heuristics as r_heuristics
from repro.core import solver as r_solver
from repro.core import timeslot as r_timeslot
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro.core import wavelength as r_wavelength
from repro_torch import convert
from repro_torch.core import (fabric, heuristics, timeslot, topology,
                              traffic, wavelength)

PLAN_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these solves run thousands of tiny torch ops,
    which spinning thread pools slow down under parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def prob(mods, name="spine-leaf", total=16.0):
    mod_topology, mod_traffic, mod_timeslot = mods
    t = mod_topology.build(name)
    cf = mod_traffic.shuffle_traffic(t, total, n_map=4, n_reduce=3, seed=2)
    return mod_timeslot.ScheduleProblem(t, cf, n_slots=6, rho=8.0)


PORT = (topology, traffic, timeslot)
REF = (r_topology, r_traffic, r_timeslot)


# ---------------------------------------------------------------------------
# heuristics: bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["spine-leaf", "bcube", "pon3",
                                  "fat-tree"])
def test_heuristic_schedules_bitwise_equal_reference(name):
    p, rp = prob(PORT, name), prob(REF, name)
    idx, paths = heuristics._shortest_paths(p)
    ridx, rpaths = r_heuristics._shortest_paths(rp)
    for k in ("kf", "ke", "kw"):
        assert np.array_equal(getattr(idx, k), getattr(ridx, k))
    assert [(q.flow, q.volume, q.tx_wavelength, q.triples.tolist())
            for q in paths] == [(q.flow, q.volume, q.tx_wavelength,
                                 q.triples.tolist()) for q in rpaths]
    for rule in ("fifo", "fair", "sebf"):
        x = heuristics.schedule(p, rule)
        assert x.tobytes() == r_heuristics.schedule(rp, rule).tobytes()
        m = timeslot.evaluate(p, x)
        assert m.feasible, (rule, name, m.max_violation)
        assert m.served.sum() == pytest.approx(p.coflow.total_gbits,
                                               rel=1e-6)


def test_sebf_at_least_as_good_as_fifo():
    p = prob(PORT)
    m_fifo = timeslot.evaluate(p, heuristics.schedule(p, "fifo"))
    m_sebf = timeslot.evaluate(p, heuristics.schedule(p, "sebf"))
    assert m_sebf.completion_s <= m_fifo.completion_s + 1e-9


# ---------------------------------------------------------------------------
# wavelength MILP: equal
# ---------------------------------------------------------------------------

def test_wavelength_small_cell_equals_reference():
    d = wavelength.CellDesign(n_racks=2)
    sol = wavelength.solve(d, time_limit=60)
    want = r_wavelength.solve(r_wavelength.CellDesign(n_racks=2),
                              time_limit=60)
    assert sol.achieved == want.achieved == 6
    assert sol.integral and want.integral
    assert np.array_equal(sol.lam, want.lam)
    assert np.array_equal(sol.hops, want.hops)
    assert sol.beta == want.beta
    assert (sol.hops[sol.lam >= 0] == 1).all()


# ---------------------------------------------------------------------------
# fabric: plans through the port's solve_fast
# ---------------------------------------------------------------------------

def same_plan(got, want, rtol=PLAN_RTOL) -> bool:
    return (got.n_slots == want.n_slots
            and np.allclose(got.share, want.share, rtol=rtol, atol=1e-6)
            and got.completion_s == pytest.approx(want.completion_s,
                                                  rel=rtol)
            and got.energy_j == pytest.approx(want.energy_j, rel=rtol))


def test_fabric_data_equals_reference():
    for multi in (False, True):
        spec, rspec = fabric.v5e_fabric(multi), r_fabric.v5e_fabric(multi)
        assert dataclasses.asdict(spec) == dataclasses.asdict(rspec)
        t, rt = fabric.fabric_topology(spec), r_fabric.fabric_topology(rspec)
        a, b = convert.problem_to_arrays(
            timeslot.ScheduleProblem(t, traffic.empty_coflow(t.n_vertices),
                                     n_slots=2)), convert.problem_to_arrays(
            r_timeslot.ScheduleProblem(
                rt, r_traffic.empty_coflow(rt.n_vertices), n_slots=2))
        for k in a:
            assert (np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray)
                    else a[k] == b[k]), k
    layers = [(f"l{i}", 50e6 + 1e6 * i) for i in range(16)]
    got = fabric.grad_buckets_for(layers, bucket_bytes=100e6,
                                  data_axes=(0, 1))
    want = r_fabric.grad_buckets_for(layers, bucket_bytes=100e6,
                                     data_axes=(0, 1))
    assert [dataclasses.asdict(b) for b in got] == [
        dataclasses.asdict(b) for b in want]


@pytest.fixture
def reference_pallas(monkeypatch):
    """The reference's plan solves with its default (xla) backend; hold
    the port to its pallas lowering, the one the port reproduces."""
    real = r_solver.solve_fast

    def pallas(*a, **kw):
        return real(*a, **{**kw, "backend": "pallas"})

    monkeypatch.setattr(r_fabric, "solve_fast", pallas)


def test_plan_matches_reference_and_ships_everything(reference_pallas):
    layers = [(f"l{i}", 50e6) for i in range(16)]
    buckets = fabric.grad_buckets_for(layers, bucket_bytes=100e6,
                                      data_axes=(0, 1))
    rbuckets = r_fabric.grad_buckets_for(layers, bucket_bytes=100e6,
                                         data_axes=(0, 1))
    plan = fabric.plan_collectives(fabric.v5e_fabric(), buckets,
                                   n_slots=10, device="cpu")
    want = r_fabric.plan_collectives(r_fabric.v5e_fabric(), rbuckets,
                                     n_slots=10)
    assert same_plan(plan, want)
    assert plan.slot_order() == want.slot_order()
    assert np.allclose(plan.share.sum(axis=(1, 2)), 1.0, atol=1e-5)
    for b, bk in enumerate(plan.buckets):
        first = int(np.argmax(plan.share[b].sum(axis=0) > 1e-9))
        assert first >= bk.release_slot


def test_axis_choice_and_restriction_match_reference(reference_pallas):
    spec, rspec = fabric.v5e_fabric(), r_fabric.v5e_fabric()
    both = [fabric.Bucket(f"b{i}", 200e6, (0, 1), 0) for i in range(8)]
    rboth = [r_fabric.Bucket(f"b{i}", 200e6, (0, 1), 0) for i in range(8)]
    plan2 = fabric.plan_collectives(spec, both, n_slots=8, device="cpu")
    plan1 = fabric.plan_collectives(
        spec, [fabric.Bucket(b.name, b.bytes, (0,), 0) for b in both],
        n_slots=8, device="cpu")
    assert same_plan(plan2, r_fabric.plan_collectives(rspec, rboth,
                                                      n_slots=8))
    assert plan2.completion_s < 0.75 * plan1.completion_s
    split = [fabric.Bucket("dp", 100e6, (0,), 0),
             fabric.Bucket("moe_a2a", 100e6, (1,), 0)]
    plan = fabric.plan_collectives(spec, split, n_slots=6, device="cpu")
    assert plan.share[0, 1].sum() < 1e-6 and plan.share[1, 0].sum() < 1e-6
    # one axis at a quarter of its rate: the plan is no faster and moves
    # load onto the healthy axis
    slow_spec = dataclasses.replace(
        spec, axis_bw=(spec.axis_bw[0] * 0.25,) + spec.axis_bw[1:])
    base = fabric.plan_collectives(spec, both[:4], n_slots=8, device="cpu")
    slow = fabric.plan_collectives(slow_spec, both[:4], n_slots=8,
                                   device="cpu")
    assert slow.completion_s >= base.completion_s - 1e-9
    assert slow.share[:, 1].sum() > base.share[:, 1].sum() - 1e-6


def test_multi_pod_plan_matches_reference(reference_pallas):
    spec = fabric.v5e_fabric(multi_pod=True)
    assert "pod" in spec.axis_names
    plan = fabric.plan_collectives(
        spec, [fabric.Bucket("x", 500e6, (0, 1, 2), 0)], n_slots=4,
        device="cpu")
    want = r_fabric.plan_collectives(
        r_fabric.v5e_fabric(multi_pod=True),
        [r_fabric.Bucket("x", 500e6, (0, 1, 2), 0)], n_slots=4)
    assert plan.completion_s > 0 and same_plan(plan, want)


def test_plan_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    with pytest.raises(RuntimeError, match="is_available"):
        fabric.plan_collectives(fabric.v5e_fabric(),
                                [fabric.Bucket("x", 1e8, (0,), 0)])
