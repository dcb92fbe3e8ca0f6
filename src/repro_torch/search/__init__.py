"""Placement-optimization subsystem: joint task placement + routing.

The port of the reference `repro.search`.  The outer loop (simulated
annealing or a small GA, repro_torch.search.optimize) proposes
`core.traffic.Placement` values; the inner evaluator prices each
candidate generation with ONE stacked batched LP fast-path dispatch
(core.solver.solve_fast_batch, every burst the CUDA kernel on
device="cuda").  See docs/PLACEMENT.md.
"""
from .moves import MOVES, migrate, propose, rotate, swap
from .optimize import (BASELINES, METHODS, Candidate, SearchConfig,
                       SearchResult, evaluate_placements,
                       optimize_placement)

__all__ = [
    "BASELINES", "METHODS", "MOVES", "Candidate", "SearchConfig",
    "SearchResult", "evaluate_placements", "migrate",
    "optimize_placement", "propose", "rotate", "swap",
]
