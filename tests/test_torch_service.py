"""The port's scheduler service against the JAX package.

`service.clock` and `service.metrics` are numpy in both packages and are
held to the reference's functions directly.  `run_service` drives every
coalesced dispatch through the burst kernel's plain version
(device="cpu"): the two-tenant `service/*` pin of
tests/golden/metrics.json holds within RTOL, two runs replay
byte-identically, coalesced equals serial, and admission control, the
fallback tier and chaos replay behave as the reference's own tests
(tests/test_service.py, tests/test_chaos.py) require.  The LP-build
prefetch thread shares the solver's caches with the main thread: a
worker's exception reaches the caller, and concurrent builds lose no
counter and never break an eviction.
"""
import dataclasses
import json
import pathlib
import sys
import threading

import numpy as np
import pytest
import torch

from repro import service as r_service
from repro.core import arrivals as r_arrivals
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro_torch import convert, service
from repro_torch.core import arrivals, solver, timeslot, topology, traffic

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden"
                     / "metrics.json").read_text())
SERVICE_KEY = "service/spine-leaf+pon3/seed0"
RTOL = 1e-4
TOPO = topology.build("spine-leaf")
LIGHT = traffic.pattern("uniform", n_map=4, n_reduce=3, total_gbits=6.0)
PATTERN = dict(n_map=4, n_reduce=3, total_gbits=8.0)
CFG = service.ServiceConfig(iters=1500, tol=2e-3,
                            backend="pallas", device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these solves run thousands of tiny torch ops,
    which spinning thread pools slow down under parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def light_tenants(n=2, n_coflows=2):
    spec = arrivals.ArrivalSpec(n_coflows=n_coflows, mean_interarrival_s=2.0)
    return [service.TenantSpec(f"t{k}", TOPO, LIGHT, spec, seed=k)
            for k in range(n)]


def golden_tenants(mod_service, mod_arrivals, mod_topology, mod_traffic):
    spec = mod_arrivals.ArrivalSpec(n_coflows=2, mean_interarrival_s=2.0)
    pat = mod_traffic.pattern("uniform", **PATTERN)
    return [mod_service.TenantSpec("dcn", mod_topology.build("spine-leaf"),
                                   pat, spec, seed=0, objective="energy"),
            mod_service.TenantSpec("pon", mod_topology.build("pon3"), pat,
                                   spec, seed=0, objective="time")]


# ---------------------------------------------------------------------------
# virtual clock, cost model, percentiles: the reference's functions
# ---------------------------------------------------------------------------

def test_clock_and_cost_model_match_reference():
    c, rc = service.VirtualClock(), r_service.VirtualClock()
    for step in (1.5, 0.0, 0.25):
        assert c.advance(step) == rc.advance(step)
    assert c.advance_to(3.0) == rc.advance_to(3.0)
    with pytest.raises(ValueError):
        c.advance(-0.1)
    with pytest.raises(ValueError):
        c.advance_to(1.0)
    for mode in service.clock.COST_MODES:
        m = service.SolveCostModel(mode=mode, base_s=0.1,
                                   per_iteration_s=1e-3, per_instance_s=0.01)
        rm = r_service.SolveCostModel(mode=mode, base_s=0.1,
                                      per_iteration_s=1e-3,
                                      per_instance_s=0.01)
        for it, b, w in ((100, 2, 99.0), (0, 1, 0.5), (4321, 7, 1e-3)):
            assert (m.cost_s(iterations=it, n_members=b, wall_s=w)
                    == rm.cost_s(iterations=it, n_members=b, wall_s=w))
    with pytest.raises(ValueError):
        service.SolveCostModel(mode="wall")


def test_percentiles_and_stats_match_reference():
    vals = np.random.default_rng(0).exponential(0.1, 257).tolist()
    for p in (1.0, 50.0, 99.0, 99.9, 100.0):
        assert (service.nearest_rank(vals, p)
                == r_service.nearest_rank(vals, p))
    assert np.isnan(service.nearest_rank([], 50.0))
    s, rs = service.LatencyStats(), r_service.LatencyStats()
    for v in vals:
        s.add(v)
        rs.add(v)
    assert (s.count, s.mean, s.max, s.p50, s.p99, s.p999) \
        == (rs.count, rs.mean, rs.max, rs.p50, rs.p99, rs.p999)
    with pytest.raises(ValueError):
        s.add(-1.0)
    assert ([f.name for f in dataclasses.fields(service.ServiceCounters)]
            == [f.name for f in dataclasses.fields(r_service.ServiceCounters)])
    rb = service.RobustnessStats(degraded_s=1.0, span_s=4.0,
                                 recoveries=[0.5, 0.25])
    rrb = r_service.RobustnessStats(degraded_s=1.0, span_s=4.0,
                                    recoveries=[0.5, 0.25])
    assert (rb.availability, rb.mean_recover_s, rb.p50_recover_s) \
        == (rrb.availability, rrb.mean_recover_s, rrb.p50_recover_s)


# ---------------------------------------------------------------------------
# the pinned two-tenant run, replay, coalescing
# ---------------------------------------------------------------------------

def test_golden_service_metrics():
    want = GOLDEN[SERVICE_KEY]
    res = service.run_service(
        golden_tenants(service, arrivals, topology, traffic),
        service.ServiceConfig(iters=3000, tol=2e-3,
                              backend="pallas", device="cpu",
                              verify_schedules=True))
    assert res.backlog_gbits == 0.0
    got = {"total_energy_j": res.total_energy_j,
           "makespan_s": res.makespan_s,
           "tenant_energy_j": [t.energy_j for t in res.tenants],
           "tenant_shipped_gbits": [t.shipped_gbits for t in res.tenants],
           "tenant_makespan_s": [t.makespan_s for t in res.tenants],
           "n_done": sum(r.status == "done" for r in res.requests),
           "arrived": res.counters.arrived,
           "admitted": res.counters.admitted}
    for key in ("n_done", "arrived", "admitted"):
        assert got[key] == want[key], key
    for key in ("total_energy_j", "makespan_s", "tenant_energy_j",
                "tenant_shipped_gbits", "tenant_makespan_s"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                   atol=1e-9, err_msg=key)


def test_tenants_and_config_carried_from_the_reference():
    """convert.py carries the reference's TenantSpecs and ServiceConfig:
    the service run from them is the run from the port's own objects,
    byte for byte."""
    rcfg = r_service.ServiceConfig(iters=3000, tol=2e-3, backend="pallas",
                                   verify_schedules=True)
    cfg = convert.service_config_from_arrays(
        convert.service_config_to_arrays(rcfg), device="cpu")
    assert cfg == service.ServiceConfig(iters=3000, tol=2e-3,
                                        backend="pallas", device="cpu",
                                        verify_schedules=True)
    tenants = [convert.tenant_from_arrays(convert.tenant_to_arrays(t))
               for t in golden_tenants(r_service, r_arrivals, r_topology,
                                       r_traffic)]
    own = golden_tenants(service, arrivals, topology, traffic)
    for a, b in zip(tenants, own):
        assert repr(convert.trace_to_arrays(a.make_trace())) \
            == repr(convert.trace_to_arrays(b.make_trace()))
    assert (service.run_service(tenants, cfg).event_log()
            == service.run_service(own, cfg).event_log())


def test_replay_byte_identical_event_log():
    tenants = light_tenants()
    r1 = service.run_service(tenants, CFG)
    r2 = service.run_service(tenants, CFG)
    log = r1.event_log()
    assert log == r2.event_log()
    assert len(log.splitlines()) == len(r1.events) > 0
    assert r1.total_energy_j == r2.total_energy_j
    assert r1.latency.samples == r2.latency.samples
    assert r1.backlog_gbits == 0.0
    assert all(r.status == "done" for r in r1.requests)
    kinds = {"arrive", "admit", "shed", "defer", "dispatch", "sched",
             "retry", "exec", "done"}
    ts = []
    for ev in r1.events:
        assert ev.kind in kinds
        assert ev.line.startswith(f"t={ev.t:.6f} {ev.kind} ")
        ts.append(ev.t)
    assert ts == sorted(ts)


def test_coalesced_equals_serial_service_run():
    tenants = light_tenants(n=3)
    coal = service.run_service(tenants, CFG)
    serial = service.run_service(
        tenants, dataclasses.replace(CFG, coalesce=False,
                                     overlap_build=False))
    assert coal.counters.dispatches < serial.counters.dispatches
    for a, b in zip(coal.tenants, serial.tenants):
        assert a.energy_j == pytest.approx(b.energy_j, rel=RTOL)
        assert a.makespan_s == pytest.approx(b.makespan_s, rel=RTOL)
        assert a.shipped_gbits == pytest.approx(b.shipped_gbits, rel=RTOL)
        assert a.n_done == b.n_done
    done_c = {(r.tenant, r.coflow_id): r.t_done for r in coal.requests}
    done_s = {(r.tenant, r.coflow_id): r.t_done for r in serial.requests}
    assert done_c.keys() == done_s.keys()
    for k in done_c:
        assert done_c[k] == pytest.approx(done_s[k], rel=RTOL, abs=1e-6)


def test_slo_accounting_exact():
    tenant = service.TenantSpec(
        "t0", TOPO, LIGHT, None, trace=arrivals.trace_at_t0(
            [traffic.generate(TOPO, LIGHT, s) for s in range(2)]))
    cost = service.SolveCostModel(base_s=0.5, per_iteration_s=0.0,
                                  per_instance_s=0.0)
    r = service.run_service([tenant], dataclasses.replace(
        CFG, cost=cost, slo_p99_s=0.4))
    assert r.latency.p50 == r.latency.p99 == r.latency.p999 == 0.5
    assert r.counters.slo_breaches == 2
    r2 = service.run_service([tenant], dataclasses.replace(
        CFG, cost=cost, slo_p99_s=0.6))
    assert r2.counters.slo_breaches == 0


# ---------------------------------------------------------------------------
# admission control under overload
# ---------------------------------------------------------------------------

def flood(n):
    return service.TenantSpec(
        "f", TOPO, LIGHT,
        arrivals.ArrivalSpec(family="burst", n_coflows=n, burst_size=n,
                             mean_interarrival_s=0.1), seed=3)


def test_overload_sheds_past_queue_bound():
    r = service.run_service([flood(10)],
                            dataclasses.replace(CFG, max_pending=4))
    assert (r.counters.arrived, r.counters.shed, r.counters.admitted) \
        == (10, 6, 4)
    shed = [rq for rq in r.requests if rq.status == "shed"]
    assert len(shed) == 6 and all(np.isnan(rq.t_decision) for rq in shed)
    assert r.latency.count == 4
    assert sum(" shed " in line for line in r.event_log().splitlines()) == 6
    assert r.backlog_gbits == 0.0


def test_backlog_cap_defers_then_serves():
    r = service.run_service([flood(4)], dataclasses.replace(
        CFG, max_backlog_gbits=LIGHT.total_gbits))
    assert r.counters.deferred > 0 and r.counters.shed == 0
    assert all(rq.status == "done" for rq in r.requests)
    assert r.backlog_gbits == 0.0
    assert r.latency.max > r.latency.percentile(1.0)


# ---------------------------------------------------------------------------
# the fallback tier
# ---------------------------------------------------------------------------

def _starve_solver(monkeypatch):
    """Make every LP result claim residual demand: the retry ladder then
    exhausts, handing each window to the fallback tier."""
    real_group = solver.solve_fast_group
    real_warm = solver.solve_fast_warm
    monkeypatch.setattr(
        solver, "solve_fast_group",
        lambda *a, **k: [dataclasses.replace(r, remaining_gbits=1.0)
                         for r in real_group(*a, **k)])
    monkeypatch.setattr(
        solver, "solve_fast_warm",
        lambda *a, **k: dataclasses.replace(real_warm(*a, **k),
                                            remaining_gbits=1.0))


def test_fallback_tier_rescues_starved_solver(monkeypatch):
    _starve_solver(monkeypatch)
    cfg = dataclasses.replace(CFG, iters=200, fallback_policy="scf",
                              verify_schedules=True)
    r = service.run_service(light_tenants(), cfg)
    assert r.counters.fallbacks > 0
    assert r.backlog_gbits <= 1e-6
    assert sum(e.kind == "fallback" for e in r.events) \
        == r.counters.fallbacks
    assert all(e.line.endswith("policy=scf") for e in r.events
               if e.kind == "fallback")
    assert all(rq.status == "done" for rq in r.requests)


def test_fallback_disabled_churns_retries(monkeypatch):
    _starve_solver(monkeypatch)
    r = service.run_service(light_tenants(), dataclasses.replace(
        CFG, iters=200, fallback_policy=None))
    assert r.counters.fallbacks == 0 and r.counters.retries > 0
    assert not any(e.kind == "fallback" for e in r.events)


def test_healthy_run_never_falls_back():
    on = service.run_service(light_tenants(), CFG)
    off = service.run_service(light_tenants(),
                              dataclasses.replace(CFG, fallback_policy=None))
    assert on.counters.fallbacks == off.counters.fallbacks == 0
    assert on.event_log() == off.event_log()


def test_solver_errors_are_not_fallback_conditions(monkeypatch):
    """The fallback tier is a scheduling rung: an error raised by the
    solve itself propagates out of run_service, it is never a reason to
    hand the window to a policy."""
    def broken(*a, **k):
        raise RuntimeError("burst failed")

    monkeypatch.setattr(solver, "solve_fast_group", broken)
    with pytest.raises(RuntimeError, match="burst failed"):
        service.run_service(light_tenants(), CFG)


# ---------------------------------------------------------------------------
# chaos replay per tenant
# ---------------------------------------------------------------------------

def test_chaos_service_replay_is_deterministic_and_certified():
    pat = traffic.pattern("uniform", n_map=4, n_reduce=3, total_gbits=6.0)
    spec = arrivals.ArrivalSpec(n_coflows=3, mean_interarrival_s=1.0)
    tenants = [service.TenantSpec(f"c{k}", TOPO, pat, spec, seed=k)
               for k in range(2)]
    cfg = dataclasses.replace(CFG, chaos=("storm",), chaos_seed=0)
    r1 = service.run_service(tenants, cfg)
    r2 = service.run_service(tenants, cfg)
    assert r1.event_log() == r2.event_log()
    rb = r1.robustness
    assert rb.events_applied == r1.counters.chaos_events > 0
    assert 0.0 <= rb.availability < 1.0
    injected = sum(rq.gbits for rq in r1.requests)
    shipped = sum(t.shipped_gbits for t in r1.tenants)
    assert injected == pytest.approx(
        shipped + r1.backlog_gbits + rb.deferred_gbits, abs=1e-6)
    healthy = service.run_service(tenants, CFG)
    assert not any(e.kind in ("fail", "repair") for e in healthy.events)


# ---------------------------------------------------------------------------
# the LP-build prefetch thread
# ---------------------------------------------------------------------------

def test_prefetch_exceptions_reach_the_caller(monkeypatch):
    """The golden tenants fall in two shape buckets, so every window
    prefetches the second group's LP builds on the worker thread; an
    error there surfaces from run_service (prefetch.result())."""
    real = solver.build_routing_lp
    main = threading.get_ident()

    def on_worker_raise(*a, **k):
        if threading.get_ident() != main:
            raise ValueError("prefetch build failed")
        return real(*a, **k)

    monkeypatch.setattr(solver, "build_routing_lp", on_worker_raise)
    tenants = golden_tenants(service, arrivals, topology, traffic)
    with pytest.raises(ValueError, match="prefetch build failed"):
        service.run_service(tenants, CFG)
    r = service.run_service(tenants, dataclasses.replace(
        CFG, overlap_build=False))
    assert r.backlog_gbits == 0.0


def test_concurrent_builds_keep_caches_and_counters(monkeypatch):
    """Threads building LPs over a cache smaller than their working set
    (so all of them evict constantly), as the prefetch thread and the
    main thread do, switching every microsecond: no eviction fails,
    every call is counted once, and every LP is the one a lone build
    gives."""
    monkeypatch.setattr(solver, "_STRUCTURE_CACHE_MAX", 3)
    monkeypatch.setattr(solver, "_ELL_PLAN_CACHE_MAX", 3)
    probs = []
    for name in ("spine-leaf", "pon3", "bcube", "dcell"):
        topo = topology.build(name)
        for s in range(2):
            cf = traffic.generate(topo, traffic.pattern("uniform",
                                                        **PATTERN), s)
            probs.append(timeslot.ScheduleProblem(
                topo, cf, n_slots=timeslot.suggest_n_slots(topo, cf),
                path_slack=2))
    want = [solver.build_routing_lp(p, "energy", cache=False)[0]
            for p in probs]
    solver.reset_build_caches()
    errors, rounds, n_threads = [], 12, 8

    def work(order):
        try:
            for _ in range(rounds):
                for i in order:
                    lp, _ = solver.build_routing_lp(probs[i], "energy")
                    assert np.array_equal(lp.c, want[i].c)
                    assert np.array_equal(lp.col, want[i].col)
                    solver._ell_operator_cached(lp.row, lp.col, lp.val,
                                                lp.m, lp.n)
        except Exception as e:              # noqa: BLE001 - reported below
            errors.append(e)

    orders = [np.random.default_rng(k).permutation(len(probs))
              for k in range(n_threads)]
    threads = [threading.Thread(target=work, args=(o,)) for o in orders]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    st = solver.build_cache_stats()
    calls = n_threads * rounds * len(probs)
    assert st.structure_hits + st.structure_misses == calls
    assert st.ell_hits + st.ell_misses == calls
    assert len(solver._STRUCTURE_CACHE) <= 3
    assert len(solver._ELL_PLAN_CACHE) <= 3
    solver.reset_build_caches()


def test_service_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    with pytest.raises(RuntimeError, match="is_available"):
        service.run_service(light_tenants(),
                            service.ServiceConfig(backend="pallas"))
