"""The paper's contribution: time-slotted co-flow scheduling + routing.

  topology    - the paper DCN graphs (Figs. 4-5, Table II) and the large
                generators
  traffic     - MapReduce shuffle co-flow model (§IV-B)
  arrivals    - online co-flow arrival traces + rolling-horizon driver
                (warm-started epoch re-solves, chaos replay)
  timeslot    - the time-slotted problem + exact eq.(19)-(45) accounting
  verify      - per-constraint-family feasibility certificates
  solver      - routing LP + PDHG on the card + slot packing (fast path),
                single instance and block-stacked batches, warm-started
                incremental re-solves
  failures    - degraded-topology engine (link cuts, device outages,
                capacity degradation) feeding the incremental re-solves
  chaos       - seeded failure/repair event traces replayed mid-run
  heuristics  - rule-based baseline schedules (FIFO, fair, SEBF)
  policies    - baseline scheduler policies (ECMP, least-loaded, SCF,
                fair share, the fair LP) beside the LP, and the gap
  oracle      - the exact MILP (scipy HiGHS), the sweep's spot-check
  wavelength  - AWGR cell wiring + wavelength assignment MILP (§III)
  fabric      - collective slot plans over an accelerator interconnect
"""
from . import (arrivals, chaos, fabric, failures, heuristics, oracle,
               policies, solver, timeslot, topology, traffic, verify,
               wavelength)
from .arrivals import Arrival, ArrivalSpec, OnlineResult, generate_trace, \
    run_online
from .fabric import Bucket, FabricSpec, SlotPlan, plan_collectives, v5e_fabric
from .failures import FailureScenario
from .solver import (FastPathResult, build_routing_lp, solve_fast,
                     solve_fast_batch, solve_fast_ensemble, solve_lp,
                     solve_lp_batch)
from .timeslot import Metrics, ScheduleProblem, evaluate, suggest_n_slots
from .topology import Topology, build as build_topology
from .traffic import (CoflowSet, TrafficPattern, concat_coflows,
                      empty_coflow, generate, generate_batch, pattern,
                      shuffle_traffic)

__all__ = [
    "Arrival", "ArrivalSpec", "Bucket", "CoflowSet", "FabricSpec",
    "FailureScenario", "FastPathResult", "Metrics", "OnlineResult",
    "ScheduleProblem", "SlotPlan", "Topology", "TrafficPattern", "arrivals",
    "build_routing_lp", "build_topology", "chaos", "concat_coflows",
    "empty_coflow", "evaluate", "fabric", "failures", "generate",
    "generate_batch", "generate_trace", "heuristics", "oracle", "pattern",
    "plan_collectives", "policies", "run_online", "shuffle_traffic", "solve_fast",
    "solve_fast_batch", "solve_fast_ensemble", "solve_lp", "solve_lp_batch",
    "solver", "suggest_n_slots", "timeslot", "topology", "traffic",
    "verify", "v5e_fabric", "wavelength",
]
