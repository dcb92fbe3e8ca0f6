"""Batched scenario-sweep engine for the paper's experiment grid, on the card.

The port of the reference's repro.sweep: topology x objective x
traffic-pattern x seed sweeps with the batched PDHG fast path
(core.solver.solve_fast_batch: the seed vector stacks block-diagonally
into a few adaptive dispatches of the CUDA burst kernel), every schedule
re-scored with the exact paper model (core.timeslot.evaluate), an
optional spot-check against the core.oracle MILP, and paper-style CSV +
markdown tables (the Figs. 6-14 comparisons).

CLI:  PYTHONPATH=src python -m repro_torch.sweep --topos all \\
          --objectives energy,completion --patterns uniform,skew,packed \\
          --seeds 8 --out results/sweep-torch
"""
from .report import write_csv, write_markdown
from .runner import SweepRecord, SweepSpec, run_sweep

__all__ = ["SweepRecord", "SweepSpec", "run_sweep",
           "write_csv", "write_markdown"]
