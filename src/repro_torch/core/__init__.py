"""The paper's contribution: time-slotted co-flow scheduling + routing.

  topology    - the paper DCN graphs (Figs. 4-5, Table II) and the large
                generators
  traffic     - MapReduce shuffle co-flow model (§IV-B)
  timeslot    - the time-slotted problem + exact eq.(19)-(45) accounting
  verify      - per-constraint-family feasibility certificates
  solver      - routing LP + PDHG on the card + slot packing (fast path),
                single instance and block-stacked batches
  oracle      - the exact MILP (scipy HiGHS), the sweep's spot-check
"""
from . import oracle, solver, timeslot, topology, traffic, verify
from .solver import (FastPathResult, build_routing_lp, solve_fast,
                     solve_fast_batch, solve_fast_ensemble, solve_lp,
                     solve_lp_batch)
from .timeslot import Metrics, ScheduleProblem, evaluate, suggest_n_slots
from .topology import Topology, build as build_topology
from .traffic import (CoflowSet, TrafficPattern, concat_coflows,
                      empty_coflow, generate, generate_batch, pattern,
                      shuffle_traffic)

__all__ = [
    "CoflowSet", "FastPathResult", "Metrics", "ScheduleProblem", "Topology",
    "TrafficPattern", "build_routing_lp", "build_topology",
    "concat_coflows", "empty_coflow", "evaluate", "generate",
    "generate_batch", "oracle", "pattern", "shuffle_traffic", "solve_fast",
    "solve_fast_batch", "solve_fast_ensemble", "solve_lp", "solve_lp_batch",
    "solver", "suggest_n_slots", "timeslot", "topology", "traffic",
    "verify",
]
