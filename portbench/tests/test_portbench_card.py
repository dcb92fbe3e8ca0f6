"""On the card, at the plan cell's own size: the program on three seeds
comes out correct and its lower-precision control (bf16-stored PDHG
iterates) on the same seeds does not.  Each run's numbers compared are
printed as a JSON line: the readings the limits are set from.  Run on
the chip:

    python -m pytest -q -s -m card portbench/tests
"""
import json

import pytest

from portbench import harness

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["ft16-plan-energy"])
def test_control_fails_where_the_program_passes(card, workload):
    cell = harness.find_cell(workload)
    cell.mix = dict(cell.mix, gap_plans=1)
    for seed in SEEDS:
        ok = harness.run_cell(workload, seed, 1.0, False, cell=cell)
        bad = harness.run_cell(workload, seed, 1.0, False, cell=cell,
                               control=True)
        for side, out in (("program", ok), ("control", bad)):
            print(json.dumps({
                "workload": workload, "seed": seed, "side": side,
                "correct": out["correct"], "attempted": out["attempted"],
                "checks": {k: c["value"] for k, c in out["checks"].items()}
            }), flush=True)
        assert ok["correct"], (seed, ok["checks"])
        assert not bad["correct"], (seed, bad["checks"])
