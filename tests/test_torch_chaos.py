"""The port's chaos engine against the JAX package.

`core.chaos` is numpy in both packages: event traces, their canonical
text, the trace-exact availability integrals and the replayed degraded
fabrics must be byte-identical.  Chaos replay inside `run_online` runs
through the burst kernel's plain version (device="cpu") and is held to
the reference's blocked-ELL lowering (`backend="pallas"`, Pallas in
interpret mode): the same events applied at the same boundaries, epoch
metrics within 1e-4, and the reference's own gates (a no-op storm takes
the healthy run's decisions, stranded volume is re-routed, no demand
leaks), with the certified "scf" fallback tier as the reference's
chaos cells run it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import arrivals as r_arrivals
from repro.core import chaos as r_chaos
from repro.core import solver as r_solver
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro_torch import convert
from repro_torch.core import (arrivals, chaos, failures, solver, topology,
                              traffic)

TOPOS = ["fat-tree", "spine-leaf", "bcube", "dcell", "pon3", "pon5"]
TOPO = topology.build("spine-leaf")
R_TOPO = r_topology.build("spine-leaf")
METRIC_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these solves run thousands of tiny torch ops,
    which spinning thread pools slow down under parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_trace(mod_traffic, mod_arrivals, topo, total=8.0, n_coflows=2,
                seed=0):
    pat = mod_traffic.pattern("uniform", n_map=4, n_reduce=3,
                              total_gbits=total)
    aspec = mod_arrivals.ArrivalSpec(n_coflows=n_coflows,
                                     mean_interarrival_s=1.0)
    return mod_arrivals.generate_trace(topo, pat, aspec, seed)


def storm_events(topo=TOPO, seed=0):
    return chaos.generate_preset_events(topo, ("storm",), seed)


# ---------------------------------------------------------------------------
# numpy: byte-identical to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TOPOS)
def test_traces_byte_identical_to_reference(name):
    topo, rtopo = topology.build(name), r_topology.build(name)
    for presets in (("mtbf",), ("storm",), ("mtbf", "storm")):
        for seed in (0, 1):
            got = chaos.generate_preset_events(topo, presets, seed)
            want = r_chaos.generate_preset_events(rtopo, presets, seed)
            assert got, presets
            assert chaos.format_trace(got) == r_chaos.format_trace(want)
            assert (convert.events_to_arrays(got)
                    == convert.events_to_arrays(want))
            for t_end in (1.0, 5.0, 20.0):
                assert (chaos.degraded_seconds(got, t_end)
                        == r_chaos.degraded_seconds(want, t_end))
                assert (chaos.availability(got, t_end)
                        == r_chaos.availability(want, t_end))
    spec = chaos.ChaosSpec(classes=("link3", "brownout", "degrade50"),
                           mtbf_s=2.0, storms=1)
    rspec = r_chaos.ChaosSpec(classes=("link3", "brownout", "degrade50"),
                              mtbf_s=2.0, storms=1)
    assert (chaos.format_trace(chaos.generate_events(topo, spec, 3,
                                                     tag="x"))
            == r_chaos.format_trace(r_chaos.generate_events(rtopo, rspec,
                                                            3, tag="x")))


def test_event_carrier_and_replay_match_reference():
    """Reference events carried across replay to the same degraded
    capacities, boundary by boundary, as the reference's FabricState."""
    want = r_chaos.generate_preset_events(R_TOPO, ("mtbf", "storm"), 2)
    got = convert.events_from_arrays(convert.events_to_arrays(want))
    assert all(isinstance(ev, chaos.ChaosEvent) for ev in got)
    assert chaos.format_trace(got) == r_chaos.format_trace(want)
    fab, rfab = chaos.FabricState(TOPO, got), r_chaos.FabricState(R_TOPO,
                                                                  want)
    for t in np.arange(0.0, 14.0, 0.25):
        a, ch = fab.advance_to(float(t))
        ra, rch = rfab.advance_to(float(t))
        assert [ev.line for ev in a] == [ev.line for ev in ra]
        assert ch == rch and fab.active_names == rfab.active_names
        assert fab.topo.cap.tobytes() == rfab.topo.cap.tobytes()
        assert fab.topo.name == rfab.topo.name
    assert fab.topo is TOPO


# ---------------------------------------------------------------------------
# the reference's own gates, on the port
# ---------------------------------------------------------------------------

def test_trace_pairing_order_and_validation():
    evs = chaos.generate_preset_events(TOPO, ("mtbf", "storm"), 0)
    by_id = {}
    for ev in evs:
        by_id.setdefault(ev.event_id, []).append(ev)
    for eid, pair in by_id.items():
        assert sorted(e.kind for e in pair) == ["fail", "repair"], eid
        fail = next(e for e in pair if e.kind == "fail")
        rep = next(e for e in pair if e.kind == "repair")
        assert rep.t >= fail.t and rep.scenario.name == fail.scenario.name
    keys = [(ev.t, ev.kind != "repair", ev.event_id) for ev in evs]
    assert keys == sorted(keys)
    assert all(ev.scenario.name.endswith(f"@{ev.event_id}") for ev in evs)
    for bad in (dict(classes=("no-such-class",)), dict(classes=("none",)),
                dict(mtbf_s=0.0), dict(storms=-1)):
        with pytest.raises(ValueError):
            chaos.ChaosSpec(**bad)
    with pytest.raises(ValueError):
        chaos.ChaosEvent(0.0, "explode", 0, failures.FailureScenario("x"))
    with pytest.raises(KeyError):
        chaos.generate_preset_events(TOPO, ("no-such-preset",), 0)


def test_degraded_seconds_closed_form():
    scen = failures.sample(TOPO, "link1", 0)
    evs = [chaos.ChaosEvent(1.0, "fail", 0, scen),
           chaos.ChaosEvent(3.0, "repair", 0, scen),
           chaos.ChaosEvent(2.0, "fail", 1, scen),
           chaos.ChaosEvent(2.5, "repair", 1, scen)]
    assert chaos.degraded_seconds(evs, 4.0) == pytest.approx(2.0)
    assert chaos.availability(evs, 4.0) == pytest.approx(0.5)
    assert chaos.degraded_seconds(evs, 2.5) == pytest.approx(1.5)
    assert chaos.degraded_seconds(evs[:1], 4.0) == pytest.approx(3.0)
    assert chaos.availability([], 10.0) == 1.0
    assert chaos.availability(evs, 0.0) == 1.0


def test_fabric_state_degrades_heals_and_noop_storms():
    evs = storm_events()
    fab = chaos.FabricState(TOPO, evs)
    first_fail = min(ev.t for ev in evs if ev.kind == "fail")
    applied, changed = fab.advance_to(first_fail)
    assert applied and changed and fab.degraded
    assert fab.topo.cap.sum() < TOPO.cap.sum()
    with pytest.raises(ValueError):
        fab.advance_to(first_fail - 0.5)
    assert fab.advance_to(first_fail) == ([], False)
    applied, _ = fab.advance_to(max(ev.t for ev in evs) + 1.0)
    assert fab.applied == len(evs) and fab.topo is TOPO
    assert fab.next_event_t is None
    scen = failures.sample(TOPO, "switch", 0)
    noop = chaos.FabricState(TOPO, [chaos.ChaosEvent(0.1, "fail", 0, scen),
                                    chaos.ChaosEvent(0.2, "repair", 0,
                                                     scen)])
    applied, changed = noop.advance_to(0.5)
    assert len(applied) == 2 and not changed and noop.topo is TOPO
    lscen = failures.sample(TOPO, "link1", 0)
    fab = chaos.FabricState(TOPO, [chaos.ChaosEvent(1.0, "fail", 1, lscen),
                                   chaos.ChaosEvent(1.0, "repair", 0,
                                                    lscen)])
    fab.advance_to(1.0)
    assert fab.degraded and set(fab.active_names) == {lscen.name}


# ---------------------------------------------------------------------------
# chaos replay inside run_online
# ---------------------------------------------------------------------------

def test_online_storm_replay_matches_reference():
    rtrace = small_trace(r_traffic, r_arrivals, R_TOPO, n_coflows=3)
    trace = convert.trace_from_arrays(convert.trace_to_arrays(rtrace))
    revs = r_chaos.generate_preset_events(R_TOPO, ("storm",), 0)
    evs = convert.events_from_arrays(convert.events_to_arrays(revs))
    kw = dict(iters=1500, tol=5e-3, fallback_policy="scf")
    want = r_arrivals.run_online(R_TOPO, rtrace, "energy", chaos=revs,
                                 backend="pallas", **kw)
    got = arrivals.run_online(TOPO, trace, "energy", chaos=evs,
                              device="cpu", **kw)
    again = arrivals.run_online(TOPO, trace, "energy", chaos=evs,
                                device="cpu", **kw)
    assert "\n".join(got.chaos_log) == "\n".join(again.chaos_log)
    assert got.chaos_log == want.chaos_log
    assert got.availability == want.availability
    assert got.recoveries == want.recoveries
    assert got.n_epochs == want.n_epochs
    for g, w in zip(got.epochs, want.epochs):
        assert (g.t_start, g.n_flows, g.chaos_events, g.degraded, g.warm,
                g.iterations) == (w.t_start, w.n_flows, w.chaos_events,
                                  w.degraded, w.warm, w.iterations)
        for k in ("energy_j", "shipped_gbits", "stranded_gbits",
                  "deferred_gbits"):
            assert getattr(g, k) == pytest.approx(getattr(w, k),
                                                  rel=METRIC_RTOL, abs=1e-9)
        assert g.certified and g.feasible
    assert sum(e.chaos_events for e in got.epochs) > 0
    assert 0.0 <= got.availability < 1.0
    injected = sum(a.coflow.total_gbits for a in trace)
    shipped = sum(e.shipped_gbits for e in got.epochs)
    assert injected == pytest.approx(
        shipped + got.backlog_gbits + got.deferred_failure_gbits, abs=1e-6)


def test_online_noop_storm_matches_healthy():
    trace = small_trace(traffic, arrivals, TOPO)
    scen = failures.sample(TOPO, "switch", 0)
    evs = [chaos.ChaosEvent(1e-12, "fail", 0, scen),
           chaos.ChaosEvent(2e-12, "repair", 0, scen)]
    kw = dict(iters=1500, tol=5e-3, device="cpu")
    healthy = arrivals.run_online(TOPO, trace, "energy", **kw)
    chaotic = arrivals.run_online(TOPO, trace, "energy", chaos=evs, **kw)
    assert chaotic.n_epochs == healthy.n_epochs
    for eh, ec in zip(healthy.epochs, chaotic.epochs):
        assert ec.energy_j == eh.energy_j
        assert ec.shipped_gbits == eh.shipped_gbits
        assert ec.executed_slots == eh.executed_slots
        assert ec.certified
    assert chaotic.total_energy_j == healthy.total_energy_j
    assert chaotic.epochs[0].chaos_events == 2
    assert chaotic.stranded_gbits == 0.0
    assert chaotic.deferred_failure_gbits == 0.0


def test_online_spine_outage_strands_and_recovers():
    trace = small_trace(traffic, arrivals, TOPO, total=48.0)
    spine0 = next(i for i, d in enumerate(TOPO.devices)
                  if d.name == "spine0")
    scen = failures.FailureScenario(name="spine0-down",
                                    failed_devices=(spine0,))
    evs = [chaos.ChaosEvent(0.2, "fail", 0, scen),
           chaos.ChaosEvent(2.0, "repair", 0, scen)]
    res = arrivals.run_online(TOPO, trace, "energy", epoch_s=0.5,
                              iters=1500, tol=5e-3, chaos=evs,
                              fallback_policy="scf", device="cpu")
    assert res.stranded_gbits > 1.0
    assert any(" strand " in line for line in res.chaos_log)
    assert res.recoveries and all(t >= 0.0 for t in res.recoveries)
    assert res.backlog_gbits <= 1e-6 and res.deferred_failure_gbits <= 1e-6
    assert all(e.certified and e.feasible for e in res.epochs)
    last = res.epochs[-1]
    t_end = last.t_start + last.executed_slots * TOPO.slot_duration
    assert res.availability == pytest.approx(
        chaos.availability(evs, t_end), rel=1e-9)


def test_fallback_policy_names_its_roadmap_item(monkeypatch):
    """The scf tier of run_online (ROADMAP queue 1 item 8, ported)
    against the reference's run_online(fallback_policy="scf",
    backend="pallas").  Both solvers are starved (every epoch result
    claims residual demand), so the retry ladder exhausts in every epoch
    and the tier takes each one: the policy is numpy, so from there on
    both runs carry the same flows and the chaos logs, epochs and
    energies agree bit for bit.  The tier is a scheduling rung, not an
    error handler: an error of the solve propagates."""
    def starve(mod):
        real = mod.solve_fast_warm
        monkeypatch.setattr(mod, "solve_fast_warm", lambda *a, **k:
                            dataclasses.replace(real(*a, **k),
                                                remaining_gbits=1.0))

    starve(solver)
    starve(r_solver)
    rtrace = small_trace(r_traffic, r_arrivals, R_TOPO, n_coflows=3)
    trace = convert.trace_from_arrays(convert.trace_to_arrays(rtrace))
    revs = r_chaos.generate_preset_events(R_TOPO, ("storm",), 0)
    evs = convert.events_from_arrays(convert.events_to_arrays(revs))
    kw = dict(iters=200, tol=5e-3, fallback_policy="scf")
    want = r_arrivals.run_online(R_TOPO, rtrace, "energy", chaos=revs,
                                 backend="pallas", **kw)
    got = arrivals.run_online(TOPO, trace, "energy", chaos=evs,
                              device="cpu", **kw)
    falls = [line for line in got.chaos_log if " fallback " in line]
    assert len(falls) == got.n_epochs > 1
    assert all(line.endswith("policy=scf") for line in falls)
    assert got.chaos_log == want.chaos_log
    assert got.n_epochs == want.n_epochs
    for g, w in zip(got.epochs, want.epochs):
        assert ((g.t_start, g.n_flows, g.n_slots, g.energy_j,
                 g.shipped_gbits, g.certified, g.feasible)
                == (w.t_start, w.n_flows, w.n_slots, w.energy_j,
                    w.shipped_gbits, w.certified, w.feasible))
        assert g.certified and g.feasible
    assert got.backlog_gbits <= 1e-6 and got.total_energy_j \
        == want.total_energy_j
    assert [c.t_done for c in got.coflows] == [c.t_done for c in
                                               want.coflows]

    def broken(*a, **k):
        raise RuntimeError("burst failed")

    monkeypatch.setattr(solver, "solve_fast_warm", broken)
    with pytest.raises(RuntimeError, match="burst failed"):
        arrivals.run_online(TOPO, trace, "energy", chaos=evs,
                            device="cpu", **kw)
