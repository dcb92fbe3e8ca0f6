"""The port's online-arrival engine against the JAX package.

Traces (`generate_trace`, `trace_at_t0`, `interleave_traces`,
`merge_traces`) and `flow_progress` are numpy in both packages and must
be bitwise equal.  `run_online` re-solves each epoch through the burst
kernel's plain version (device="cpu") and is held to the reference's
blocked-ELL lowering (`backend="pallas"`, Pallas in interpret mode)
within 1e-4 relative on every epoch's energy, and on everything a cold
run reports (warm runs carry an order-sensitive part, ROADMAP queue 3),
and to the reference's own gates:
one epoch reproduces `solve_fast` exactly, the rolling horizon conserves
every Gbit, and warm starts save iterations.  Also the sweep's
`--arrivals` and `--failures` axes.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import arrivals as r_arrivals
from repro.core import timeslot as r_timeslot
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro_torch import convert
from repro_torch.core import arrivals, solver, timeslot, topology, traffic
from repro_torch.sweep import report, runner

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOPO = topology.build("spine-leaf")
R_TOPO = r_topology.build("spine-leaf")
LIGHT = dict(n_map=4, n_reduce=3, total_gbits=6.0)
# heavy enough that per-mapper volume spans several 1 s epochs (rho = 8
# Gbps), so flows carry residuals forward and warm starts have work
HEAVY = dict(n_map=4, n_reduce=3, total_gbits=48.0)
METRIC_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these solves run thousands of tiny torch ops,
    which spinning thread pools slow down under parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same_trace(a, b) -> bool:
    x, y = convert.trace_to_arrays(a), convert.trace_to_arrays(b)
    return len(x) == len(y) and all(
        p.keys() == q.keys() and all(
            np.array_equal(p[k], q[k]) if isinstance(p[k], np.ndarray)
            else p[k] == q[k] for k in p) for p, q in zip(x, y))


def heavy_trace(mod_traffic, mod_arrivals, topo, seed=0):
    spec = mod_arrivals.ArrivalSpec(family="poisson", n_coflows=4,
                                    mean_interarrival_s=2.0)
    return mod_arrivals.generate_trace(
        topo, mod_traffic.pattern("uniform", **HEAVY), spec, seed=seed)


# ---------------------------------------------------------------------------
# numpy: bitwise equal to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", arrivals.FAMILIES)
def test_traces_bitwise_equal_reference(family):
    spec = arrivals.ArrivalSpec(family=family, n_coflows=6, burst_size=3)
    rspec = r_arrivals.ArrivalSpec(family=family, n_coflows=6, burst_size=3)
    pat = traffic.pattern("uniform", **LIGHT)
    rpat = r_traffic.pattern("uniform", **LIGHT)
    traces, rtraces = [], []
    for seed in (3, 4):
        got = arrivals.generate_trace(TOPO, pat, spec, seed)
        want = r_arrivals.generate_trace(R_TOPO, rpat, rspec, seed)
        assert same_trace(got, want)
        traces.append(got)
        rtraces.append(want)
    assert same_trace(arrivals.merge_traces(traces),
                      r_arrivals.merge_traces(rtraces))
    got = [(ta.tenant, ta.arrival.t_arrive, ta.arrival.coflow_id)
           for ta in arrivals.interleave_traces(traces)]
    want = [(ta.tenant, ta.arrival.t_arrive, ta.arrival.coflow_id)
            for ta in r_arrivals.interleave_traces(rtraces)]
    assert got == want
    cfs = [a.coflow for a in traces[0][:2]]
    rcfs = [a.coflow for a in rtraces[0][:2]]
    assert same_trace(arrivals.trace_at_t0(cfs), r_arrivals.trace_at_t0(rcfs))
    carried = convert.trace_from_arrays(convert.trace_to_arrays(rtraces[0]))
    assert all(isinstance(a, arrivals.Arrival) for a in carried)
    assert same_trace(carried, traces[0])


def test_flow_progress_bitwise_equal_reference():
    cf = traffic.generate(TOPO, traffic.pattern("uniform", **HEAVY), 1)
    p = timeslot.ScheduleProblem(TOPO, cf,
                                 n_slots=timeslot.suggest_n_slots(TOPO, cf),
                                 path_slack=2)
    rp = r_timeslot.ScheduleProblem(
        R_TOPO, r_traffic.generate(R_TOPO, r_traffic.pattern(
            "uniform", **HEAVY), 1), n_slots=p.n_slots, path_slack=2)
    x = solver.solve_fast(p, "energy", iters=1000, device="cpu").schedule
    for t_end in (1, 4, p.n_slots):
        got = arrivals.flow_progress(p, x, t_end)
        want = r_arrivals.flow_progress(rp, x, t_end)
        assert all(np.array_equal(g, w, equal_nan=True)
                   for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# one epoch == one-shot solve_fast, exactly
# ---------------------------------------------------------------------------

def test_single_epoch_reproduces_one_shot_solve_fast():
    pat = traffic.pattern("uniform", **LIGHT)
    cfs = [traffic.generate(TOPO, pat, s) for s in range(3)]
    res = arrivals.run_online(TOPO, arrivals.trace_at_t0(cfs), "energy",
                              iters=3000, tol=2e-3, device="cpu")
    assert res.n_epochs == 1 and not res.epochs[0].warm
    merged = traffic.concat_coflows(cfs, TOPO.n_vertices)
    p = timeslot.ScheduleProblem(
        TOPO, merged, n_slots=timeslot.suggest_n_slots(TOPO, merged),
        path_slack=2)
    ref = solver.solve_fast(p, "energy", iters=3000, tol=2e-3, device="cpu")
    assert res.last_result.metrics.energy_j == ref.metrics.energy_j
    assert res.last_result.metrics.completion_s == ref.metrics.completion_s
    assert res.total_energy_j == ref.metrics.energy_j
    assert res.backlog_gbits == 0.0
    assert all(np.isfinite(c.t_done) for c in res.coflows)


# ---------------------------------------------------------------------------
# the rolling horizon against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warm", [True, False])
def test_rolling_horizon_matches_reference(warm):
    """Every epoch starts and runs as the reference's (start, executed
    slots, warm flag), its energy within 1e-4, and every Gbit offered is
    shipped.  Cold, everything else holds too: the flows carried, the
    horizon, the iterations, each epoch's shipped Gbits within 1e-4 and
    the co-flow completion times.  Warm, the epochs that stop after one
    250-iteration chunk leave the LP near its tolerance, and which flows
    finish inside an epoch's executed prefix (a threshold on shipped
    volume), and so the flows carried and the completion times, moves
    with the fp32 summation order (ROADMAP queue 3;
    test_warm_completion_times_move_with_summation_order)."""
    rtrace = heavy_trace(r_traffic, r_arrivals, R_TOPO)
    trace = convert.trace_from_arrays(convert.trace_to_arrays(rtrace))
    kw = dict(epoch_s=1.0, iters=3000, warm=warm)
    want = r_arrivals.run_online(R_TOPO, rtrace, "energy",
                                 backend="pallas", **kw)
    got = arrivals.run_online(TOPO, trace, "energy", device="cpu", **kw)
    assert got.n_epochs == want.n_epochs > 1
    for g, w in zip(got.epochs, want.epochs):
        assert (g.t_start, g.executed_slots, g.warm) == (
            w.t_start, w.executed_slots, w.warm)
        if not warm:
            assert (g.n_flows, g.n_slots, g.iterations) == (
                w.n_flows, w.n_slots, w.iterations)
        keys = ("energy_j",) if warm else ("energy_j", "shipped_gbits",
                                           "backlog_gbits")
        for k in keys:
            assert getattr(g, k) == pytest.approx(getattr(w, k),
                                                  rel=METRIC_RTOL, abs=1e-9)
    keys = ("total_energy_j",) if warm else ("total_energy_j", "makespan_s",
                                             "mean_response_s")
    for k in keys:
        assert getattr(got, k) == pytest.approx(getattr(want, k),
                                                rel=METRIC_RTOL)
    if not warm:
        assert got.total_iterations == want.total_iterations
    # the reference's gates: conservation and completion
    offered = sum(a.coflow.total_gbits for a in trace)
    assert all(e.feasible for e in got.epochs)
    assert got.backlog_gbits <= 1e-6
    np.testing.assert_allclose(sum(e.shipped_gbits for e in got.epochs),
                               offered, rtol=1e-9)
    for c in got.coflows:
        assert np.isfinite(c.t_done) and c.t_done >= c.t_arrive
    assert [e.t_start for e in got.epochs] == sorted(
        e.t_start for e in got.epochs)
    assert any(e.warm for e in got.epochs[1:]) == warm


def test_warm_completion_times_move_with_summation_order():
    """The order-sensitivity the warm case above leaves out, shown in the
    port alone: the plain version summing each row in torch's order and
    in the CUDA kernel's order (pdhg_update_burst(order="kernel")) runs
    the same epochs with the same energies and ships every Gbit, but
    whether a flow finishes inside an epoch is a threshold on its
    shipped volume: a later epoch carries another number of flows, and
    the mean co-flow response moves by more than 1e-4."""
    import functools
    from unittest import mock
    from repro_torch.kernels import pdhg_spmv
    trace = heavy_trace(traffic, arrivals, TOPO)
    kw = dict(epoch_s=1.0, iters=3000, device="cpu")
    torch_order = arrivals.run_online(TOPO, trace, "energy", **kw)
    with mock.patch.object(pdhg_spmv, "pdhg_update_burst",
                           functools.partial(pdhg_spmv.pdhg_update_burst,
                                             order="kernel")):
        kernel_order = arrivals.run_online(TOPO, trace, "energy", **kw)
    assert torch_order.n_epochs == kernel_order.n_epochs
    for a, b in zip(torch_order.epochs, kernel_order.epochs):
        assert (a.t_start, a.warm, a.energy_j) == (b.t_start, b.warm,
                                                   b.energy_j)
    assert any(a.n_flows != b.n_flows for a, b in
               zip(torch_order.epochs, kernel_order.epochs))
    for r in (torch_order, kernel_order):
        assert r.backlog_gbits <= 1e-6
    rel = (abs(torch_order.mean_response_s - kernel_order.mean_response_s)
           / kernel_order.mean_response_s)
    assert rel > METRIC_RTOL


def test_warm_restarts_save_iterations():
    trace = heavy_trace(traffic, arrivals, TOPO)
    kw = dict(epoch_s=1.0, iters=3000, device="cpu")
    cold = arrivals.run_online(TOPO, trace, "energy", warm=False, **kw)
    warm = arrivals.run_online(TOPO, trace, "energy", warm=True, **kw)
    assert not any(e.warm for e in cold.epochs)
    assert warm.total_iterations < cold.total_iterations
    assert warm.warm_iterations > 0.0
    assert warm.backlog_gbits <= 1e-6 and cold.backlog_gbits <= 1e-6


def test_idle_gap_truncation_and_mid_epoch_arrival():
    light = traffic.pattern("uniform", **LIGHT)
    heavy = traffic.pattern("uniform", **HEAVY)
    cf = traffic.generate(TOPO, light, 0)
    res = arrivals.run_online(TOPO, [arrivals.Arrival(5.0, cf, 0)],
                              "energy", epoch_s=1.0, iters=2000,
                              device="cpu")
    first = res.epochs[0]
    assert first.n_flows == 0 and first.demand_gbits == 0.0
    assert first.feasible and first.energy_j == 0.0
    assert res.n_epochs <= 3 and res.epochs[-1].t_start >= 5.0
    assert res.backlog_gbits == 0.0 and res.coflows[0].t_done >= 5.0
    tr = [arrivals.Arrival(0.0, traffic.generate(TOPO, heavy, 0), 0),
          arrivals.Arrival(100.0, traffic.generate(TOPO, heavy, 1), 1)]
    cut = arrivals.run_online(TOPO, tr, "energy", epoch_s=1.0, iters=2000,
                              max_epochs=1, device="cpu")
    assert cut.n_epochs == 1
    assert cut.backlog_gbits > tr[1].coflow.total_gbits
    assert np.isnan(cut.mean_response_s) and np.isnan(cut.makespan_s)
    D = TOPO.slot_duration
    mid = [arrivals.Arrival(0.0, traffic.generate(TOPO, heavy, 0), 0),
           arrivals.Arrival(2.5 * D, traffic.generate(TOPO, light, 1), 1)]
    res = arrivals.run_online(TOPO, mid, "energy", iters=1500, tol=2e-3,
                              device="cpu")
    assert res.backlog_gbits == 0.0
    done = {c.coflow_id: c for c in res.coflows}
    assert np.isfinite(done[1].t_done) and done[1].t_done > done[1].t_arrive
    assert sum(e.n_admitted for e in res.epochs) == 2


def test_run_online_rejects_and_defaults_to_the_card():
    with pytest.raises(ValueError):
        arrivals.ArrivalSpec(family="nope")
    with pytest.raises(ValueError):
        arrivals.run_online(TOPO, [], "latency", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    cf = traffic.generate(TOPO, traffic.pattern("uniform", **LIGHT), 0)
    with pytest.raises(RuntimeError, match="is_available"):
        arrivals.run_online(TOPO, arrivals.trace_at_t0([cf]), "energy")


# ---------------------------------------------------------------------------
# the sweep's --arrivals and --failures axes
# ---------------------------------------------------------------------------

def test_sweep_arrivals_axis(tmp_path):
    spec = runner.SweepSpec(
        topos=("spine-leaf",), objectives=("energy",),
        patterns=("uniform",), seeds=(0,), arrivals=("poisson",),
        arrival_coflows=3, total_gbits=8.0, n_map=4, n_reduce=3,
        iters=1200, oracle_check=0, device="cpu")
    records, problems = runner.run_sweep(spec)
    assert len(records) == len(problems) == 2
    online = [r for r in records if r.arrivals != "none"]
    assert len(online) == 1
    rec = online[0]
    assert rec.epochs >= 1 and rec.feasible
    assert rec.n_flows == 3 * 12 and rec.backlog_gbits <= 1e-6
    assert rec.mean_response_s > 0.0
    header = report.write_csv(records, tmp_path / "r.csv"
                              ).read_text().splitlines()[0].split(",")
    for col in ("arrivals", "epochs", "mean_response_s", "backlog_gbits",
                "warm_iterations"):
        assert col in header
    md = report.write_markdown(records, tmp_path / "r.md").read_text()
    assert "Online arrivals" in md and "poisson" in md
    with pytest.raises(ValueError, match="arrival family"):
        runner.SweepSpec(topos=("spine-leaf",),
                         arrivals=("weekly",)).validate()
    assert {f.name for f in dataclasses.fields(rec)} >= {
        "arrivals", "epochs", "mean_response_s", "backlog_gbits",
        "warm_iterations"}


def test_sweep_failures_axis(tmp_path):
    spec = runner.SweepSpec(topos=("spine-leaf",), objectives=("energy",),
                            patterns=("uniform",), seeds=(0, 1),
                            failures=("link1",), total_gbits=6.0, n_map=4,
                            n_reduce=3, iters=1200, oracle_check=0,
                            device="cpu")
    records, problems = runner.run_sweep(spec)
    assert len(records) == len(problems) == 4
    degraded = [r for r in records if r.failure == "link1"]
    assert len(degraded) == 2
    for r in degraded:
        assert r.feasible
        assert 0.0 < r.degradation_ratio < 1.0
        assert 0.0 < r.survivability <= 1.0 + 1e-9
    md = report.write_markdown(records, tmp_path / "r.md").read_text()
    assert "Degraded fabrics" in md
    for bad in ("meteor", "none"):
        with pytest.raises(ValueError, match="failure preset"):
            runner.SweepSpec(topos=("spine-leaf",),
                             failures=(bad,)).validate()


@pytest.mark.parametrize("axis,table", [("--failures", "Degraded fabrics"),
                                        ("--arrivals", "Online arrivals")])
def test_sweep_cli_new_axes_on_the_cpu(tmp_path, axis, table):
    value = "link1" if axis == "--failures" else "poisson"
    out = tmp_path / "s"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.sweep", "--device", "cpu",
         "--topos", "spine-leaf", "--objectives", "energy", "--patterns",
         "uniform", "--seeds", "2", "--total-gbits", "6", "--n-map", "4",
         "--n-reduce", "3", axis, value, "--oracle-check", "0", "--out",
         str(out)], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    assert "(0 infeasible)" in proc.stdout
    assert table in (out / "results.md").read_text()
