"""CLI for the batched scenario sweep, on the card.

Example (the paper's full grid, 8 seeds per cell):

    PYTHONPATH=src python -m repro_torch.sweep --topos all \
        --objectives energy,completion --patterns uniform,skew,packed \
        --seeds 8 --out results/sweep-torch

Writes <out>/results.csv (one row per instance, exact paper-model
metrics) and <out>/results.md (mean +/- std tables per objective).
Takes the reference's flags (python -m repro.sweep) plus --device
("cuda", the default, raises without a card; "cpu" runs the burst
kernel's plain version).  The flags of axes the port does not run yet
exit 1 naming their ROADMAP item.  Exit code 1 when any instance is
infeasible.
"""
from __future__ import annotations

import argparse
import pathlib
import time

from ..core import topology, traffic
from .report import write_csv, write_markdown
from .runner import ALL_TOPOS, OBJECTIVES, UNPORTED, SweepSpec, run_sweep

# the reference's axis flags, by the SweepSpec field each fills; the port
# does not run these axes yet and SweepSpec.validate names their items
_AXIS_FLAGS = {"failures": "--failures", "policies": "--policy",
               "placement_search": "--placement-search",
               "arrivals": "--arrivals", "chaos": "--chaos"}


def _csv_list(value: str, universe, what: str) -> tuple[str, ...]:
    if value == "all":
        return tuple(universe)
    items = tuple(v.strip() for v in value.split(",") if v.strip())
    for v in items:
        if v not in universe:
            raise SystemExit(f"unknown {what} {v!r}; choose from "
                             f"{sorted(universe)} or 'all'")
    return items


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep",
        description="Batched co-flow scheduling sweep over the paper's "
                    "DCNs, objectives, and traffic patterns, on the card.")
    ap.add_argument("--topos", default="all",
                    help=f"comma list or 'all' ({', '.join(ALL_TOPOS)})")
    ap.add_argument("--objectives", default="energy,completion",
                    help="comma list: energy, completion")
    ap.add_argument("--patterns", default="uniform,skew,packed",
                    help=f"comma list or 'all' "
                         f"({', '.join(traffic.PATTERNS)})")
    ap.add_argument("--seeds", type=int, default=8,
                    help="number of seeds per grid cell (0..N-1)")
    for field, flag in _AXIS_FLAGS.items():
        ap.add_argument(flag, dest=field, nargs="?", const="all",
                        default="",
                        help=f"not ported yet (ROADMAP {UNPORTED[field]})")
    ap.add_argument("--service", type=int, default=0, metavar="N",
                    help="not ported yet (ROADMAP queue 1 item 9)")
    ap.add_argument("--jax-cache", default="",
                    help="not ported: the port compiles nothing with JAX "
                         "(ROADMAP queue 1 item 5)")
    ap.add_argument("--total-gbits", type=float, default=30.0)
    ap.add_argument("--n-map", type=int, default=10)
    ap.add_argument("--n-reduce", type=int, default=6)
    ap.add_argument("--slots", type=int, default=0,
                    help="fixed slot count (default: auto per instance)")
    ap.add_argument("--iters", type=int, default=3000,
                    help="PDHG iterations before residual-driven restarts")
    ap.add_argument("--backend", default="pallas", choices=("xla", "pallas"),
                    help="PDHG lowering: only pallas (the blocked-ELL "
                         "burst, the CUDA kernel on the card) is ported")
    ap.add_argument("--mesh", type=int, default=1,
                    help="row-partition every PDHG dispatch across this "
                         "many devices (not ported yet beyond 1)")
    ap.add_argument("--precision", default="fp32", choices=("fp32", "bf16"),
                    help="PDHG iterate storage: fp32 (default) or bf16 "
                         "(arithmetic and residuals stay fp32)")
    ap.add_argument("--oracle-check", type=int, default=2,
                    help="instances to spot-check against the exact MILP "
                         "(cheapest first; 0 disables)")
    ap.add_argument("--oracle-time-limit", type=float, default=60.0)
    ap.add_argument("--profile", action="store_true",
                    help="print a build/solve/report wall-time split per "
                         "grid cell (with structure-cache hit/miss "
                         "deltas from core.solver.build_cache_stats)")
    ap.add_argument("--device", default="cuda",
                    help="where the PDHG bursts run: cuda (default; the "
                         "CUDA kernel, raises without a card) or cpu")
    ap.add_argument("--out", default="results/sweep-torch",
                    help="output directory for results.csv / results.md")
    args = ap.parse_args(argv)

    if args.service:
        raise SystemExit("error: --service is not ported yet (ROADMAP "
                         "queue 1 item 9)")
    if args.jax_cache:
        raise SystemExit("error: --jax-cache is not ported: the port "
                         "compiles nothing with JAX (ROADMAP queue 1 item 5)")
    if args.backend != "pallas":
        raise SystemExit("error: --backend xla (the COO scatter lowering) "
                         "is not ported yet (ROADMAP queue 1, the COO "
                         "lowering question)")

    spec = SweepSpec(
        topos=_csv_list(args.topos, topology.BUILDERS, "topology"),
        objectives=_csv_list(args.objectives, OBJECTIVES, "objective"),
        patterns=_csv_list(args.patterns, traffic.PATTERNS, "pattern"),
        seeds=tuple(range(args.seeds)),
        **{field: (getattr(args, field),) if getattr(args, field) else ()
           for field in _AXIS_FLAGS},
        total_gbits=args.total_gbits, n_map=args.n_map,
        n_reduce=args.n_reduce, n_slots=args.slots or None,
        iters=args.iters, mesh=args.mesh, precision=args.precision,
        oracle_check=args.oracle_check,
        oracle_time_limit=args.oracle_time_limit,
        profile=args.profile, device=args.device)

    try:
        spec.validate()
    except ValueError as e:
        raise SystemExit(f"error: {e}")

    t0 = time.perf_counter()
    records, _ = run_sweep(spec, log=print)
    out = pathlib.Path(args.out)
    t_report = time.perf_counter()
    csv_path = write_csv(records, out / "results.csv")
    md_path = write_markdown(records, out / "results.md")
    if args.profile:
        print(f"    profile report: "
              f"{(time.perf_counter() - t_report) * 1e3:.1f} ms")
    n_inf = sum(not r.feasible for r in records)
    print(f"\n{len(records)} instances in {time.perf_counter()-t0:.1f} s "
          f"({n_inf} infeasible) -> {csv_path}, {md_path}")
    return 1 if n_inf else 0


if __name__ == "__main__":
    raise SystemExit(main())
