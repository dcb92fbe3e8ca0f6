"""Every cell of BENCHMARK.json finds its files by name, and the file
keeps to the benchmark's contract."""
import json
import re

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell = harness.find_cell(workload)
    assert (harness.HERE / "drivers" / f"{cell.mix['entry']}.py").is_file()
    assert (harness.HERE / "topologies"
            / f"{cell.config['builder']}.py").is_file()
    for m in cell.per_layer:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    assert {"feasibility_gbit"} <= set(cell.limits)


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for c in BENCH["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
