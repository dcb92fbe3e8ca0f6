"""Online co-flow arrivals on the port via the Python API (the CLI drives
grids).

The port's counterpart of examples/online_arrivals.py.  Draws a seeded
Poisson arrival trace of shuffle co-flows, then runs the rolling-horizon
driver twice — cold (every epoch re-solves from zero) and warm (every
epoch starts from the previous epoch's projected PDHG state, carried
residual flows mapped to their new indices) — and prints the per-epoch
picture: admitted co-flows, backlog, and the PDHG iterations each
re-plan cost.

Run:  PYTHONPATH=src python examples_torch/online_arrivals.py
          [--device cpu] [--backend pallas]
"""
import argparse

from repro_torch.core import arrivals, topology, traffic
from repro_torch.device import resolve


def run(device="cuda", backend="xla", *, topo="spine-leaf", n_map=4,
        n_reduce=3, total_gbits=48.0, n_coflows=5, mean_interarrival_s=2.0,
        seed=0, epoch_s=1.0, iters=3000) -> dict:
    """Run the trace cold and warm; returns the printed numbers by
    "cold" and "warm", and under "results" each OnlineResult."""
    device = resolve(device)
    topo = topology.build(topo)
    pat = traffic.pattern("uniform", n_map=n_map, n_reduce=n_reduce,
                          total_gbits=total_gbits)
    spec = arrivals.ArrivalSpec(family="poisson", n_coflows=n_coflows,
                                mean_interarrival_s=mean_interarrival_s)
    trace = arrivals.generate_trace(topo, pat, spec, seed=seed)
    print(f"{topo.name}: {len(trace)} co-flows "
          f"({pat.n_map}x{pat.n_reduce} tasks, {pat.total_gbits:g} Gbit "
          f"each), arrivals at "
          + ", ".join(f"{a.t_arrive:.1f}s" for a in trace))
    out: dict = {"arrivals": [a.t_arrive for a in trace], "results": []}
    for warm in (False, True):
        r = arrivals.run_online(topo, trace, "energy", warm=warm,
                                epoch_s=epoch_s, iters=iters,
                                backend=backend, device=device)
        label = "warm" if warm else "cold"
        print(f"\n--- {label} epoch re-solves ---")
        print("epoch  t(s)  new  flows  backlog(Gbit)  PDHG iters")
        for e in r.epochs:
            print(f"{e.index:5d}  {e.t_start:4.0f}  {e.n_admitted:3d}  "
                  f"{e.n_flows:5d}  {e.backlog_gbits:13.1f}  "
                  f"{e.iterations:6d}{'  (warm)' if e.warm else ''}")
        print(f"total: {r.total_iterations} iters, "
              f"E = {r.total_energy_j:.0f} J, "
              f"mean response = {r.mean_response_s:.2f} s, "
              f"makespan = {r.makespan_s:.2f} s")
        out[label] = {
            "epochs": [(e.index, e.t_start, e.n_admitted, e.n_flows,
                        e.backlog_gbits, e.iterations, e.warm)
                       for e in r.epochs],
            "total_iterations": r.total_iterations,
            "total_energy_j": r.total_energy_j,
            "mean_response_s": r.mean_response_s,
            "makespan_s": r.makespan_s}
        out["results"].append(r)
    print("\nFull grid: PYTHONPATH=src python -m repro_torch.sweep "
          "--topos spine-leaf --arrivals poisson,burst --seeds 4")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("xla", "pallas"), default="xla")
    args = ap.parse_args(argv)
    return run(args.device, args.backend)


if __name__ == "__main__":
    main()
