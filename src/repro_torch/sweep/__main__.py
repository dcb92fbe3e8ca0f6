"""CLI for the batched scenario sweep, on the card.

Example (the paper's full grid, 8 seeds per cell):

    PYTHONPATH=src python -m repro_torch.sweep --topos all \
        --objectives energy,completion --patterns uniform,skew,packed \
        --seeds 8 --out results/sweep-torch

Writes <out>/results.csv (one row per instance, exact paper-model
metrics) and <out>/results.md (mean +/- std tables per objective, plus
the degraded-fabric table with --failures, the policy table with
--policy, the placement table with --placement-search, the online-
arrivals table with --arrivals and the chaos table with --chaos, whose
replayed event traces also go to <out>/chaos_events.log).  --service N
runs the multi-tenant scheduler service instead and writes its event
log to <out>/service_events.log.
Takes the reference's flags (python -m repro.sweep) plus --device
("cuda", the default, raises without a card; "cpu" runs the burst
kernel's plain version).  --mesh > 1, --backend xla and --jax-cache are
not ported and exit 1 naming their ROADMAP item.  Exit code 1 when any
instance is infeasible.
"""
from __future__ import annotations

import argparse
import pathlib
import time

from .. import search
from ..core import arrivals, failures, topology, traffic
from ..core import chaos as chaosmod
from ..core import policies as policy_zoo
from .report import write_csv, write_markdown
from .runner import ALL_TOPOS, OBJECTIVES, SweepSpec, run_sweep


def _csv_list(value: str, universe, what: str) -> tuple[str, ...]:
    if value == "all":
        return tuple(universe)
    items = tuple(v.strip() for v in value.split(",") if v.strip())
    for v in items:
        if v not in universe:
            raise SystemExit(f"unknown {what} {v!r}; choose from "
                             f"{sorted(universe)} or 'all'")
    return items


def _run_service_smoke(args) -> int:
    """The --service mode: one deterministic virtual-clock service run.

    Builds N tenants cycling through the requested topologies and
    patterns (seeded 0..N-1, poisson arrivals of --arrival-coflows
    co-flows at --arrival-mean-s), runs repro_torch.service.run_service
    on --device under the deterministic "iterations" cost model, prints
    the latency/SLO/admission summary, and writes the canonical event
    log.  Exit code 1 if any demand leaked (nonzero backlog with an
    un-truncated run)."""
    from .. import service

    topos = _csv_list(args.topos, topology.BUILDERS, "topology")
    pats = _csv_list(args.patterns, traffic.PATTERNS, "pattern")
    spec = arrivals.ArrivalSpec(n_coflows=args.arrival_coflows,
                                mean_interarrival_s=args.arrival_mean_s)
    tenants = [
        service.TenantSpec(
            name=f"tenant{k}", topo=topology.build(topos[k % len(topos)]),
            pattern=traffic.pattern(pats[k % len(pats)],
                                    total_gbits=args.total_gbits,
                                    n_map=args.n_map,
                                    n_reduce=args.n_reduce),
            arrivals=spec, seed=k)
        for k in range(args.service)]
    chaos = (_csv_list(args.chaos, chaosmod.PRESETS, "chaos preset")
             if args.chaos else ())
    cfg = service.ServiceConfig(window_s=args.epoch_s or None,
                                iters=args.iters, device=args.device,
                                slo_p99_s=args.slo_s,
                                chaos=chaos, chaos_seed=args.chaos_seed)
    t0 = time.perf_counter()
    res = service.run_service(tenants, cfg)
    wall = time.perf_counter() - t0
    c, lat = res.counters, res.latency
    print(f"service: {args.service} tenants, {c.arrived} arrivals, "
          f"{c.windows} windows in {wall:.1f} s wall")
    print(f"  latency p50={lat.p50:.6f} p99={lat.p99:.6f} "
          f"p999={lat.p999:.6f} s (SLO {args.slo_s:g} s, "
          f"{c.slo_breaches} breaches)")
    print(f"  admitted={c.admitted} shed={c.shed} deferred={c.deferred}")
    print(f"  dispatches={c.dispatches} (solver {c.solver_dispatches}, "
          f"bucket hits {c.bucket_hits}) retries={c.retries}")
    print(f"  makespan={res.makespan_s:.3f} s "
          f"energy={res.total_energy_j:.1f} J "
          f"backlog={res.backlog_gbits:.6f} Gbits")
    if chaos:
        rb, dlat = res.robustness, res.latency_degraded
        print(f"  Availability={rb.availability:.4f} "
              f"(events={rb.events_applied}, "
              f"degraded {rb.degraded_s:.2f}/{rb.span_s:.2f} tenant-s)")
        print(f"  stranded={rb.stranded_gbits:.6f} Gbits re-routed, "
              f"deferred-by-failure={rb.deferred_gbits:.6f} Gbits, "
              f"recoveries={len(rb.recoveries)} "
              f"(mean ttr={rb.mean_recover_s:.3f} s)")
        print(f"  degraded-mode latency p99={dlat.p99:.6f} s "
              f"({dlat.count} decisions under degradation)")
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    log_path = out / "service_events.log"
    log_path.write_text(res.event_log() + "\n")
    print(f"  event log -> {log_path} ({len(res.events)} events)")
    # deferred-by-failure demand is a fabric outcome, not a leak; only
    # routable demand left behind fails the smoke
    return 1 if res.backlog_gbits > 1e-6 else 0


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
    ap.add_argument("--failures", nargs="?", const="all", default="",
                    help="failure presets for degraded-fabric re-solves: "
                         f"comma list or 'all' "
                         f"({', '.join(k for k in failures.SCENARIOS if k != 'none')}); "
                         "bare --failures means 'all'")
    ap.add_argument("--policy", nargs="?", const="all", default="",
                    help="baseline-policy axis (core.policies): run each "
                         "named policy on every LP instance and record "
                         "the optimal-vs-practical gap; comma list or "
                         "'all'; bare --policy means 'all'")
    ap.add_argument("--placement-search", nargs="?", const="all",
                    default="",
                    help="joint placement + routing axis "
                         "(repro_torch.search): per topology x objective "
                         "x seed, optimize the task placement with the "
                         "named methods and record optimized-vs-fixed "
                         "gain rows; comma list or 'all' "
                         f"({', '.join(search.METHODS)}); bare "
                         "--placement-search means 'all'")
    ap.add_argument("--placement-budget", type=int, default=6,
                    help="placement-search generations per run (each is "
                         "one stacked batched evaluator dispatch)")
    ap.add_argument("--placement-population", type=int, default=8,
                    help="placement candidates per stacked dispatch")
    ap.add_argument("--arrivals", nargs="?", const="all", default="",
                    help="online-arrival families for rolling-horizon "
                         "re-solves (core.arrivals): comma list or 'all' "
                         f"({', '.join(arrivals.FAMILIES)}); "
                         "bare --arrivals means 'all'")
    ap.add_argument("--chaos", nargs="?", const="all", default="",
                    help="chaos-replay axis (core.chaos): per preset and "
                         "seed, replay a deterministic failure/repair "
                         "event trace under a rolling-horizon poisson "
                         "run, recording availability, stranded Gbits, "
                         "time-to-recover, and deferred-by-failure "
                         "demand; comma list or 'all' "
                         f"({', '.join(chaosmod.PRESETS)}); bare --chaos "
                         "means 'all'; also writes the per-cell event "
                         "traces to <out>/chaos_events.log")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="offset added to per-cell seeds when drawing "
                         "chaos event traces (--service mode)")
    ap.add_argument("--arrival-coflows", type=int, default=5,
                    help="co-flows per arrival trace")
    ap.add_argument("--arrival-mean-s", type=float, default=2.0,
                    help="mean inter-arrival gap in seconds")
    ap.add_argument("--epoch-s", type=float, default=0.0,
                    help="rolling-horizon re-plan period in seconds "
                         "(default: 4 slot durations)")
    ap.add_argument("--service", type=int, default=0, metavar="N",
                    help="smoke-run the multi-tenant scheduler service "
                         "(repro_torch.service) with N tenants cycling "
                         "through --topos/--patterns instead of "
                         "sweeping; prints decision-latency p50/p99/p999, "
                         "shed/defer/bucket-hit counters, and writes the "
                         "canonical event log to "
                         "<out>/service_events.log")
    ap.add_argument("--slo-s", type=float, default=0.25,
                    help="decision-latency SLO for --service breach "
                         "accounting (seconds)")
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

    if args.jax_cache:
        raise SystemExit("error: --jax-cache is not ported: the port "
                         "compiles nothing with JAX (ROADMAP queue 1 item 5)")
    if args.backend != "pallas":
        raise SystemExit("error: --backend xla (the COO scatter lowering) "
                         "is not ported yet (ROADMAP queue 1, the COO "
                         "lowering question)")
    if args.service:
        return _run_service_smoke(args)

    fail_universe = {k: v for k, v in failures.SCENARIOS.items()
                     if k != "none"}
    spec = SweepSpec(
        topos=_csv_list(args.topos, topology.BUILDERS, "topology"),
        objectives=_csv_list(args.objectives, OBJECTIVES, "objective"),
        patterns=_csv_list(args.patterns, traffic.PATTERNS, "pattern"),
        seeds=tuple(range(args.seeds)),
        failures=(_csv_list(args.failures, fail_universe, "failure preset")
                  if args.failures else ()),
        arrivals=(_csv_list(args.arrivals, arrivals.FAMILIES,
                            "arrival family")
                  if args.arrivals else ()),
        chaos=(_csv_list(args.chaos, chaosmod.PRESETS, "chaos preset")
               if args.chaos else ()),
        policies=(_csv_list(args.policy, policy_zoo.POLICIES, "policy")
                  if args.policy else ()),
        placement_search=(_csv_list(args.placement_search, search.METHODS,
                                    "placement-search method")
                          if args.placement_search else ()),
        placement_generations=args.placement_budget,
        placement_population=args.placement_population,
        arrival_coflows=args.arrival_coflows,
        arrival_mean_s=args.arrival_mean_s,
        epoch_s=args.epoch_s or None,
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
    if spec.chaos:
        # the replayed event traces, regenerated byte-identically: they
        # are pure functions of (topology, preset, seed), so this is
        # exactly what every chaos cell above saw
        trace_lines = []
        for topo_name in spec.topos:
            topo = topology.build(topo_name)
            for preset in spec.chaos:
                for seed in spec.seeds:
                    evs = chaosmod.generate_preset_events(
                        topo, (preset,), int(seed))
                    trace_lines.append(f"# topo={topo_name} "
                                       f"chaos={preset} seed={seed}")
                    trace_lines.append(chaosmod.format_trace(evs))
        trace_path = out / "chaos_events.log"
        trace_path.write_text("\n".join(trace_lines) + "\n")
        print(f"chaos event traces -> {trace_path}")
    if args.profile:
        print(f"    profile report: "
              f"{(time.perf_counter() - t_report) * 1e3:.1f} ms")
    n_inf = sum(not r.feasible for r in records)
    print(f"\n{len(records)} instances in {time.perf_counter()-t0:.1f} s "
          f"({n_inf} infeasible) -> {csv_path}, {md_path}")
    return 1 if n_inf else 0


if __name__ == "__main__":
    raise SystemExit(main())
