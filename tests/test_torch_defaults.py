"""The port's default PDHG lowering is the reference's: backend="xla".

  * every entry point and config that takes a `backend` has the
    reference counterpart's default, and so do the sweep CLI's and the
    examples' `--backend`; core.fabric's plan names no backend in
    either package;
  * a call that names no backend gives the reference's default answer:
    `solve_fast` on the six paper topologies x {energy, time} bitwise,
    `run_online` on tests/test_arrivals.py's heavy trace epoch by epoch,
    where test_torch_coo's probe shows that this host's XLA orders the
    reference's scatters as the COO kernel's plain version does (else
    those cases skip, naming why); the sweep CLI's rows read backend
    "xla" and the summation-order-sensitive row its committed 2152 J;
  * the scale knobs (bf16 storage, shards > 1) without
    backend="pallas" are refused as the reference refuses them.

Everything runs on the CPU at small sizes, on one torch thread.
"""
import argparse
import csv
import dataclasses
import inspect
import pathlib

import numpy as np
import pytest
import torch

from repro.core import arrivals as r_arrivals
from repro.core import fabric as r_fabric
from repro.core import policies as r_policies
from repro.core import solver as r_solver
from repro.core import timeslot as r_timeslot
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro.search import optimize as r_optimize
from repro.service import loop as r_loop
from repro.sweep import __main__ as r_sweep_main
from repro.sweep import runner as r_runner
from repro_torch.core import (arrivals, fabric, policies, solver, timeslot,
                              topology, traffic, verify)
from repro_torch.search import optimize
from repro_torch.service import loop
from repro_torch.sweep import __main__ as sweep_main
from repro_torch.sweep import runner
from test_torch_coo import _bitwise_or_skip
from test_torch_examples import example

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN_PATTERN = dict(n_map=4, n_reduce=3, total_gbits=8.0)
TOPOS = ("spine-leaf", "fat-tree", "bcube", "dcell", "pon3", "pon5")
# the examples that solve, each with the --backend flag
SOLVING_EXAMPLES = ("quickstart", "pattern_sweep", "failure_sweep",
                    "online_arrivals")
# the sweep row whose pallas result moves with the summation order
# (ROADMAP queue 3 C) and the committed reference run it belongs to
ORDER_ROW = ("spine-leaf", "energy", "skew", "5")
SWEEP_RESULTS = ROOT / "results" / "sweep" / "results.csv"


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU bursts are many small ops; one intra-op thread
    keeps parallel test workers from oversubscribing the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Parsed(Exception):
    """Raised with a CLI's parsed arguments, before it runs anything."""


def _parsed_default(main, monkeypatch) -> str:
    """The `--backend` a CLI's main() parses when given no flag."""
    real = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(_Parsed) as got:
        main([])
    return got.value.args[0].backend


def _arg_default(fn) -> str:
    return inspect.signature(fn).parameters["backend"].default


def _field_default(cls) -> str:
    return {f.name: f.default for f in dataclasses.fields(cls)}["backend"]


def _fabric_backend(mod, monkeypatch) -> str:
    """The backend a package's plan_collectives names in its solve_fast
    call ("(none)" when it names none and so takes the default)."""
    seen = []

    def record(*a, **kw):
        seen.append(kw.get("backend", "(none)"))
        raise _Parsed()

    monkeypatch.setattr(mod, "solve_fast", record)
    kw = {} if mod is r_fabric else dict(device="cpu")
    with pytest.raises(_Parsed):
        mod.plan_collectives(mod.v5e_fabric(),
                             [mod.Bucket("x", 1e8, (0,), 0)], **kw)
    return seen[0]


# (port, reference): how to read each side's default
DEFAULTS = {
    "solve_lp": lambda mp: (_arg_default(solver.solve_lp),
                            _arg_default(r_solver.solve_lp)),
    "solve_fast": lambda mp: (_arg_default(solver.solve_fast),
                              _arg_default(r_solver.solve_fast)),
    "solve_lp_batch": lambda mp: (_arg_default(solver.solve_lp_batch),
                                  _arg_default(r_solver.solve_lp_batch)),
    "solve_fast_batch": lambda mp: (_arg_default(solver.solve_fast_batch),
                                    _arg_default(r_solver.solve_fast_batch)),
    "solve_fast_ensemble": lambda mp: (
        _arg_default(solver.solve_fast_ensemble),
        _arg_default(r_solver.solve_fast_ensemble)),
    "resolve_incremental": lambda mp: (
        _arg_default(solver.resolve_incremental),
        _arg_default(r_solver.resolve_incremental)),
    "solve_fast_warm": lambda mp: (_arg_default(solver.solve_fast_warm),
                                   _arg_default(r_solver.solve_fast_warm)),
    "solve_fast_group": lambda mp: (_arg_default(solver.solve_fast_group),
                                    _arg_default(r_solver.solve_fast_group)),
    "Policy.solve": lambda mp: (_arg_default(policies.Policy.solve),
                                _arg_default(r_policies.Policy.solve)),
    "FairLpPolicy.solve": lambda mp: (
        _arg_default(policies.FairLpPolicy.solve),
        _arg_default(r_policies.FairLpPolicy.solve)),
    "run_online": lambda mp: (_arg_default(arrivals.run_online),
                              _arg_default(r_arrivals.run_online)),
    "SearchConfig": lambda mp: (_field_default(optimize.SearchConfig),
                                _field_default(r_optimize.SearchConfig)),
    "ServiceConfig": lambda mp: (_field_default(loop.ServiceConfig),
                                 _field_default(r_loop.ServiceConfig)),
    "SweepSpec": lambda mp: (_field_default(runner.SweepSpec),
                             _field_default(r_runner.SweepSpec)),
    "SweepRecord": lambda mp: (_field_default(runner.SweepRecord),
                               _field_default(r_runner.SweepRecord)),
    "sweep._record": lambda mp: (_arg_default(runner._record),
                                 _arg_default(r_runner._record)),
    "sweep --backend": lambda mp: (_parsed_default(sweep_main.main, mp),
                                   _parsed_default(r_sweep_main.main, mp)),
    "plan_collectives": lambda mp: (_fabric_backend(fabric, mp),
                                    _fabric_backend(r_fabric, mp)),
    # the reference's examples name no backend: they run its solvers'
    # default
    **{f"{name}.run": (lambda mp, name=name: (
        _arg_default(example(name).run), _arg_default(r_solver.solve_fast)))
       for name in SOLVING_EXAMPLES},
    **{f"{name} --backend": (lambda mp, name=name: (
        _parsed_default(example(name).main, mp),
        _arg_default(r_solver.solve_fast)))
       for name in SOLVING_EXAMPLES},
}


@pytest.mark.parametrize("entry", list(DEFAULTS))
def test_backend_defaults_are_the_references(entry, monkeypatch):
    got, want = DEFAULTS[entry](monkeypatch)
    assert got == want, entry
    assert want in ("xla", "(none)")


# ---------------------------------------------------------------------------
# a call that names no backend gives the reference's default answer
# ---------------------------------------------------------------------------

def _problem(mod_topology, mod_traffic, mod_timeslot, name):
    topo = mod_topology.build(name)
    cf = mod_traffic.generate_batch(
        topo, mod_traffic.pattern("uniform", **GOLDEN_PATTERN), [0])[0]
    return mod_timeslot.ScheduleProblem(
        topo, cf, n_slots=mod_timeslot.suggest_n_slots(topo, cf),
        path_slack=2)


@pytest.mark.parametrize("objective", ["energy", "time"])
@pytest.mark.parametrize("name", TOPOS)
def test_default_solve_fast_is_the_references_bitwise(name, objective):
    _bitwise_or_skip()
    p = _problem(topology, traffic, timeslot, name)
    got = solver.solve_fast(p, objective, device="cpu")
    want = r_solver.solve_fast(_problem(r_topology, r_traffic, r_timeslot,
                                        name), objective)
    verify.check_schedule(p, got.schedule).assert_ok(f"{name}/{objective}")
    assert got.iterations == want.iterations
    assert np.array_equal(got.lp_x, want.lp_x)
    assert np.array_equal(got.lp_y, want.lp_y)
    assert np.array_equal(got.schedule, want.schedule)
    for k in ("energy_j", "completion_s", "fairness_term"):
        assert getattr(got.metrics, k) == getattr(want.metrics, k), k
    assert np.array_equal(got.metrics.served, want.metrics.served)


def test_default_run_online_carries_the_references_flows():
    """tests/test_arrivals.py's heavy trace (spine-leaf, 4 poisson
    co-flows of 48 Gbit, epochs of 1 s), warm, no backend named: every
    epoch carries the reference's flows (ROADMAP queue 3 D: under
    "pallas" epoch 3's count moves with the summation order) and runs
    its iterations, energy and shipped volume."""
    _bitwise_or_skip()
    spec = dict(family="poisson", n_coflows=4, mean_interarrival_s=2.0)
    heavy = dict(n_map=4, n_reduce=3, total_gbits=48.0)
    kw = dict(epoch_s=1.0, iters=3000)
    rtopo, topo = r_topology.build("spine-leaf"), topology.build("spine-leaf")
    want = r_arrivals.run_online(
        rtopo, r_arrivals.generate_trace(
            rtopo, r_traffic.pattern("uniform", **heavy),
            r_arrivals.ArrivalSpec(**spec), seed=0), "energy", **kw)
    got = arrivals.run_online(
        topo, arrivals.generate_trace(
            topo, traffic.pattern("uniform", **heavy),
            arrivals.ArrivalSpec(**spec), seed=0), "energy", device="cpu",
        **kw)
    assert got.n_epochs == want.n_epochs > 1
    assert any(e.warm for e in got.epochs)
    assert [e.n_flows for e in got.epochs] == [e.n_flows
                                               for e in want.epochs]
    for g, w in zip(got.epochs, want.epochs):
        for f in ("t_start", "warm", "iterations", "energy_j",
                  "shipped_gbits"):
            assert getattr(g, f) == getattr(w, f), f
    assert got.mean_response_s == want.mean_response_s


def test_default_sweep_cli_reads_xla_and_the_committed_row(tmp_path):
    """The sweep CLI with no --backend at its default sizes on spine-leaf
    / energy / skew, seeds 0-5: every row's backend column reads xla,
    and seeds 4 and 5 are the committed reference rows, seed 5's 2152 J
    among them (ROADMAP queue 3 C: under "pallas" the card reads 2153)."""
    rc = sweep_main.main(["--device", "cpu", "--topos", "spine-leaf",
                          "--objectives", "energy", "--patterns", "skew",
                          "--seeds", "6", "--oracle-check", "0", "--out",
                          str(tmp_path)])
    assert rc == 0

    def rows(path):
        """The healthy fast path's rows (chip_smoke.py's sweep_rows)."""
        with open(path, newline="") as fh:
            return {(r["topo"], r["objective"], r["pattern"], r["seed"]): r
                    for r in csv.DictReader(fh)
                    if r["failure"] == "none" and r["policy"] == "lp"
                    and r["arrivals"] == "none"
                    and r["placement_search"] == "none"}

    got, committed = rows(tmp_path / "results.csv"), rows(SWEEP_RESULTS)
    assert {r["backend"] for r in got.values()} == {"xla"}
    assert float(got[ORDER_ROW]["energy_j"]) == 2152.0
    for seed in ("4", "5"):
        key = ORDER_ROW[:3] + (seed,)
        for col in ("energy_j", "completion_s"):
            assert float(got[key][col]) == pytest.approx(
                float(committed[key][col]), rel=1e-4), (key, col)


# ---------------------------------------------------------------------------
# the scale knobs need backend="pallas", as in the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knob", [dict(shards=2), dict(precision="bf16")],
                         ids=["shards", "bf16"])
def test_scale_knobs_without_a_backend_are_refused(knob):
    p = _problem(topology, traffic, timeslot, "pon3")
    rp = _problem(r_topology, r_traffic, r_timeslot, "pon3")
    with pytest.raises(ValueError) as got:
        solver.solve_fast(p, "energy", device="cpu", **knob)
    with pytest.raises(ValueError) as want:
        r_solver.solve_fast(rp, "energy", **knob)
    assert str(got.value) == str(want.value)
    assert "backend='pallas'" in str(got.value)
    spec = dict(mesh=knob.get("shards", 1),
                precision=knob.get("precision", "fp32"))
    with pytest.raises(ValueError) as got:
        runner.SweepSpec(**spec, device="cpu").validate()
    with pytest.raises(ValueError) as want:
        r_runner.SweepSpec(**spec).validate()
    assert str(got.value) == str(want.value)
    flag = (["--mesh", "2"] if "shards" in knob
            else ["--precision", "bf16"])
    with pytest.raises(SystemExit) as got:
        sweep_main.main(["--device", "cpu", *flag])
    with pytest.raises(SystemExit) as want:
        r_sweep_main.main(flag)
    assert "backend='pallas'" in got.value.code
    assert "backend='pallas'" in want.value.code
