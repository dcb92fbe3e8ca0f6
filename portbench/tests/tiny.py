"""Tiny cells for the CPU tests: each benchmark cell's files, with the
topology and the shuffles cut to a size the CPU runs in a second."""
from portbench import harness

TINY = {
    "ft16-plan-energy": ({"k": 4}, dict(n_map=3, n_reduce=2,
                                       total_gbits=4.0, gap_plans=1)),
}


def cell(workload: str) -> harness.Cell:
    c = harness.find_cell(workload)
    args, mix = TINY[workload]
    c.config = dict(c.config, args=args)
    c.mix = dict(c.mix, **mix)
    return c


def run(workload: str, seed: int = 2 ** 31 + 11, **kw) -> dict:
    return harness.run_cell(workload, seed, 0.01, False, device="cpu",
                            cell=cell(workload), **kw)
