"""The reference against the port on the CPU at a tiny size: it builds
the same LP, scores a schedule the port made as the port does, and
rejects that schedule with one capacity broken or a flow's demand
missing."""
import numpy as np
import pytest

from portbench import gen, harness
from portbench.reference import model

TOPOS = {"fat-tree": {"k": 4}}


def plan(builder, objective, seed=7):
    P = harness.program()
    arrays = harness.topology_arrays({"builder": builder,
                                      "args": TOPOS[builder]})
    fab = model.Fabric.from_arrays(arrays)
    topo = harness.program_topology(P, arrays)
    src, dst, size = gen.shuffle(gen.rng(seed, "test"), gen.Sites(arrays),
                                 n_map=3, n_reduce=2, total_gbits=4.0,
                                 skew="daytona", placement="spread")
    cf = P.traffic.CoflowSet(src, dst, size, topo.n_vertices)
    p = P.timeslot.ScheduleProblem(
        topo, cf, n_slots=P.timeslot.suggest_n_slots(topo, cf),
        path_slack=0)
    r = P.solver.solve_fast(p, objective, device="cpu")
    mask = model.admissible(fab, src, dst, 0)
    return P, p, r, fab, (src, dst, size), mask


@pytest.mark.parametrize("builder", sorted(TOPOS))
@pytest.mark.parametrize("objective", ["energy", "time"])
def test_reference_agrees_with_port(builder, objective):
    P, p, r, fab, (src, dst, size), mask = plan(builder, objective)
    assert np.array_equal(mask, p.flow_edge_mask)
    ref = P.topology.build(builder, **TOPOS[builder])
    assert np.array_equal(ref.edges, p.topo.edges)
    assert np.array_equal(ref.cap, p.topo.cap)
    lp, _ = P.solver.build_routing_lp(p, objective)
    T = r.schedule.shape[3]
    assert model.lp_size(fab, src, dst, size, mask, T, objective, 8.0) \
        == (lp.n, lp.m, len(lp.val))
    sc = model.check_schedule(fab, src, dst, size, mask,
                              model.dense_to_entries(r.schedule), rho=8.0)
    assert max(sc["residuals"].values()) <= 1e-9
    assert sc["energy_j"] == pytest.approx(r.metrics.energy_j, rel=1e-12)
    assert sc["completion_s"] == pytest.approx(r.metrics.completion_s,
                                               rel=1e-12)
    lpc = model.lp_check(fab, src, dst, size, mask, T, objective, 8.0,
                         r.lp_x)
    assert lpc["residual"] <= 1e-4
    assert lpc["value"] == pytest.approx(r.lp_lower_bound, rel=1e-9)


def broken(x, p, how):
    x = x.copy()
    if how == "capacity":
        f, e, w, t = np.unravel_index(np.argmax(x), x.shape)
        x[f, e, w, t] += p.topo.cap[e, w] * p.topo.slot_duration
    else:
        x[0] = 0.0
    return x


@pytest.mark.parametrize("how,family", [("capacity", "capacity"),
                                        ("demand", "demand")])
def test_reference_rejects_a_broken_schedule(how, family):
    P, p, r, fab, (src, dst, size), mask = plan("fat-tree", "energy")
    x = broken(r.schedule, p, how)
    sc = model.check_schedule(fab, src, dst, size, mask,
                              model.dense_to_entries(x), rho=8.0)
    assert sc["residuals"][family] > 1e-2
    assert not P.verify.check_schedule(p, x).ok
