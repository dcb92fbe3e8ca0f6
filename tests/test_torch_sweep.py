"""The port's sweep (`python -m repro_torch.sweep`) on the CPU against the
reference's sweep with its blocked-ELL lowering (`backend="pallas"`,
Pallas in interpret mode), the report writers, the CLI, and the MILP
oracle copy."""
import dataclasses
import functools
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import oracle as r_oracle
from repro.core import timeslot as r_timeslot
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro.sweep import report as r_report
from repro.sweep import runner as r_runner
from repro_torch.core import oracle, timeslot, topology, traffic
from repro_torch.sweep import __main__ as sweep_main
from repro_torch.sweep import report, runner

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the same spec on both sides: spine-leaf, min-energy, uniform placement
SPEC = dict(topos=("spine-leaf",), objectives=("energy",),
            patterns=("uniform",), seeds=(0, 1), total_gbits=8.0, n_map=4,
            n_reduce=3, iters=1200)
# exact paper-model metrics of the packed schedules: the port and the
# reference differ only in fp32 sum order inside PDHG
METRIC_RTOL = 1e-4
# columns that are measured (wall time) or numeric outputs of the solve
TIMED = {"solve_s"}
FLOATS = {"energy_j", "completion_s", "max_violation", "lp_lower_bound",
          "lp_primal_residual", "remaining_gbits", "survivability"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These solves run thousands of tiny torch ops; one intra-op thread
    keeps parallel test workers from oversubscribing the CPU with
    spinning thread pools, which slows such ops by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _sweeps():
    got, _ = runner.run_sweep(runner.SweepSpec(**SPEC,
                                               backend="pallas", device="cpu"))
    want, _ = r_runner.run_sweep(r_runner.SweepSpec(**SPEC,
                                                    backend="pallas"))
    return got, want


def test_sweep_rows_match_reference_pallas():
    got, want = _sweeps()
    assert len(got) == len(want) == 2
    assert [f.name for f in dataclasses.fields(runner.SweepRecord)] == [
        f.name for f in dataclasses.fields(r_runner.SweepRecord)]
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        for key, wv in wd.items():
            gv = gd[key]
            if key in TIMED:
                continue
            if key in FLOATS:
                assert math.isclose(gv, wv, rel_tol=METRIC_RTOL,
                                    abs_tol=1e-6), (key, gv, wv)
            elif isinstance(wv, float) and math.isnan(wv):
                assert math.isnan(gv), key
            else:
                assert gv == wv, (key, gv, wv)
        assert g.backend == "pallas" and g.feasible


def test_report_writers_match_reference(tmp_path):
    got, _ = _sweeps()
    # the same records as the reference's record type
    as_ref = [r_runner.SweepRecord(**dataclasses.asdict(r)) for r in got]
    assert report.CSV_FIELDS == r_report.CSV_FIELDS
    for mine, theirs, name in ((report.write_csv, r_report.write_csv,
                                "results.csv"),
                               (report.write_markdown,
                                r_report.write_markdown, "results.md")):
        a = mine(got, tmp_path / "port" / name).read_bytes()
        b = theirs(as_ref, tmp_path / "ref" / name).read_bytes()
        assert a == b, name
    md = (tmp_path / "port" / "results.md").read_text()
    assert "## Objective: min-energy" in md and "| spine-leaf |" in md


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.sweep", *args],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))


def test_cli_on_the_cpu_writes_results(tmp_path):
    out = tmp_path / "sweep"
    proc = _cli("--device", "cpu", "--backend", "pallas", "--topos", "pon3",
                "--objectives", "energy", "--patterns", "uniform", "--seeds",
                "1", "--total-gbits", "8", "--n-map", "4", "--n-reduce", "3",
                "--oracle-check", "0", "--out", str(out))
    assert proc.returncode == 0, proc.stderr
    assert "(0 infeasible)" in proc.stdout
    rows = (out / "results.csv").read_text().splitlines()
    assert rows[0].split(",") == report.CSV_FIELDS and len(rows) == 2
    assert (out / "results.md").exists()


@pytest.mark.parametrize("args,match", [
    (["--topos", "nope"], "unknown topology"),
    (["--patterns", "nope"], "unknown pattern"),
    (["--objectives", "nope"], "unknown objective"),
    # ported since: the test ids name what these cases once checked, and
    # test_cli_runs_each_ported_axis_on_the_cpu runs each axis
    pytest.param(["--failures", "none"], "unknown failure preset 'none'",
                 id="args3-failures axis is not ported yet (ROADMAP queue 1 "
                    "item 6"),
    pytest.param(["--policy", "lottery"], "unknown policy 'lottery'",
                 id="args4-policies axis is not ported yet (ROADMAP queue 1 "
                    "item 8"),
    pytest.param(["--placement-search", "tabu"],
                 "unknown placement-search method 'tabu'", id="args5-item 8"),
    pytest.param(["--arrivals", "weekly"], "unknown arrival family",
                 id="args6-item 7"),
    pytest.param(["--chaos", "hurricane"], "unknown chaos preset "
                                           "'hurricane'", id="args7-item 7"),
    pytest.param(["--service", "2", "--chaos", "hurricane"],
                 "unknown chaos preset 'hurricane'", id="args8-item 9"),
    (["--jax-cache", "cache"], "item 5"),
    # ported since (tests/test_torch_coo.py runs --backend xla): the
    # case now holds that an unknown lowering is refused
    pytest.param(["--backend", "bogus"], "unknown solver backend 'bogus'",
                 id="args10-COO"),
    # ported since: outside torchrun it names the launch
    pytest.param(["--mesh", "2"], "torchrun --nproc-per-node 2",
                 id="args11-item 10"),
    (["--n-map", "40", "--topos", "pon3"], "task servers"),
])
def test_cli_rejects_bad_names_and_unported_flags(args, match):
    # SystemExit with a message: Python prints it and exits with code 1
    with pytest.raises(SystemExit) as exc:
        sweep_main.main(["--device", "cpu", "--backend", "pallas", *args])
    assert isinstance(exc.value.code, str) and match in exc.value.code


# each axis of the reference's at its test's size (tests/test_policies.py,
# tests/test_search.py, tests/test_chaos.py, tests/test_service.py)
SMALL = ["--device", "cpu", "--backend", "pallas", "--topos", "spine-leaf",
         "--objectives", "energy", "--patterns", "uniform", "--seeds", "1",
         "--total-gbits", "8", "--n-map", "4", "--n-reduce", "3", "--iters",
         "1200", "--oracle-check", "0"]


@pytest.mark.parametrize("args,table,log", [
    pytest.param(["--policy", "ecmp,scf,fair"], "Optimal-vs-practical gap",
                 None, id="policy"),
    pytest.param(["--placement-search", "sa,ga", "--placement-budget", "1",
                  "--placement-population", "4"], "Placement search", None,
                 id="placement-search"),
    pytest.param(["--chaos", "storm", "--arrival-coflows", "2"],
                 "Availability under chaos", "chaos_events.log", id="chaos"),
    pytest.param(["--service", "2", "--topos", "spine-leaf,pon3",
                  "--arrival-coflows", "2"], None, "service_events.log",
                 id="service"),
])
def test_cli_runs_each_ported_axis_on_the_cpu(args, table, log, tmp_path,
                                              capsys):
    rc = sweep_main.main([*SMALL, *args, "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    if table is not None:
        assert "(0 infeasible)" in out.strip().splitlines()[-1]
        assert table in (tmp_path / "results.md").read_text()
    else:
        assert "latency p50=" in out and "backlog=0.000000" in out
    if log is not None:
        text = (tmp_path / log).read_text()
        assert text.startswith("# topo=spine-leaf chaos=storm seed=0\n"
                               if log == "chaos_events.log" else "t=")
        assert (" fail " in text if log == "chaos_events.log"
                else " done " in text)


def test_cli_unported_flag_exits_1_cleanly():
    # --mesh 2 is ported; outside torchrun it exits 1 naming the launch
    proc = _cli("--device", "cpu", "--backend", "pallas", "--mesh", "2")
    assert proc.returncode == 1
    assert proc.stderr.strip() == (
        "error: --mesh 2 runs one process a shard: launch with torchrun "
        "--nproc-per-node 2 -m repro_torch.sweep --mesh 2 ...")


def test_spec_rejects_unported_axes_naming_the_roadmap_item():
    runner.SweepSpec(chaos=("storm",), policies=("scf",),
                     placement_search=("sa",),
                     backend="pallas", device="cpu").validate()
    for bad, match in ((dict(chaos=("nope",)), "unknown chaos preset"),
                       (dict(policies=("nope",)), "unknown policy"),
                       (dict(placement_search=("nope",)),
                        "unknown placement-search method"),
                       (dict(placement_search=("sa",),
                             placement_population=0),
                        "population >= 1")):
        with pytest.raises(ValueError, match=match):
            runner.SweepSpec(**bad, backend="pallas", device="cpu").validate()
    # mesh > 1 is ported: the spec validates (the CLI sets up the ranks)
    runner.SweepSpec(mesh=2, backend="pallas", device="cpu").validate()


def test_oracle_matches_reference_on_a_tiny_instance():
    def tiny(mod_topology, mod_traffic, mod_timeslot):
        topo = mod_topology.build("pon3")
        cf = mod_traffic.generate(topo, mod_traffic.pattern(
            "uniform", n_map=2, n_reduce=2, total_gbits=4.0), 0)
        return mod_timeslot.ScheduleProblem(topo, cf, n_slots=3)

    got = oracle.solve(tiny(topology, traffic, timeslot), "energy",
                       time_limit=60.0)
    want = r_oracle.solve(tiny(r_topology, r_traffic, r_timeslot), "energy",
                          time_limit=60.0)
    assert got.status == want.status and got.mip_gap == want.mip_gap
    assert got.objective_value == want.objective_value
    assert np.array_equal(got.schedule, want.schedule)
    assert got.metrics.energy_j == want.metrics.energy_j
    assert got.metrics.completion_s == want.metrics.completion_s
