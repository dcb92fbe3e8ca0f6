"""Quickstart on the port: the paper's co-flow scheduler end to end.

The port's counterpart of examples/quickstart.py.  Builds the PON3
(AWGR-centric) cell and a spine-leaf DCN, schedules the same MapReduce
shuffle on both with each objective, exactly (the host MILP oracle) and
on the fast path (the routing LP through the PDHG burst kernel), and
prints the energy/completion-time trade-off the paper's §VI reports.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
          [--backend pallas]

--device defaults to the card ("cuda") and raises without one; --device
cpu runs the kernels' plain versions on the host.  --backend defaults to
xla, the reference's default COO lowering; --backend pallas solves in
blocked ELL.
"""
import argparse

from repro_torch.core import oracle, solver, timeslot, topology, traffic
from repro_torch.device import resolve

TOTAL_GBITS = 8.0


def run(device="cuda", backend="xla", *, topos=("spine-leaf", "pon3"),
        total_gbits=TOTAL_GBITS, n_map=4, n_reduce=3, seed=1, n_slots=6,
        rho=8.0, iters=4000, time_limit=120) -> dict:
    """Solve and print each (topology, objective); returns the printed
    numbers by (topology, objective), and under "results" each
    (problem, fast-path result)."""
    device = resolve(device)
    out: dict = {"results": []}
    for name in topos:
        topo = topology.build(name)
        coflow = traffic.shuffle_traffic(topo, total_gbits, n_map=n_map,
                                         n_reduce=n_reduce, seed=seed)
        prob = timeslot.ScheduleProblem(topo, coflow, n_slots=n_slots,
                                        rho=rho)
        print(f"\n=== {name}: {coflow.n_flows} flows, "
              f"{coflow.total_gbits:g} Gbit shuffle ===")
        for objective in ("time", "energy"):
            exact = oracle.solve_lexico(prob, objective,
                                        time_limit=time_limit)
            fast = solver.solve_fast(prob, objective, iters=iters,
                                     backend=backend, device=device)
            em, fm = exact.metrics, fast.metrics
            print(f"  min-{objective:6s}  oracle: M={em.completion_s:.3f}s "
                  f"E={em.energy_j:7.1f}J   |   fast path: "
                  f"M={fm.completion_s:.3f}s E={fm.energy_j:7.1f}J "
                  f"(feasible={fm.feasible})")
            out[name, objective] = {
                "oracle_completion_s": em.completion_s,
                "oracle_energy_j": em.energy_j,
                "completion_s": fm.completion_s, "energy_j": fm.energy_j,
                "feasible": fm.feasible}
            out["results"].append((prob, fast))
    print("\nPON3 vs electronic: note the ~an-order-of-magnitude energy gap "
          "at min-energy — the paper's §VI-B headline.")
    print("Next: examples_torch/pattern_sweep.py (batched multi-seed API) "
          "or the full grid via `python -m repro_torch.sweep` (see README).")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("xla", "pallas"), default="xla")
    args = ap.parse_args(argv)
    return run(args.device, args.backend)


if __name__ == "__main__":
    main()
