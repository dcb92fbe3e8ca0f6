"""Mini scenario sweep on the port via the Python API (the CLI drives the
full grid).

The port's counterpart of examples/pattern_sweep.py.  Compares the three
traffic placements on the AWGR PON cell: the cell-local pattern keeps the
shuffle inside racks (polymer backplanes), so it completes faster and
cheaper than the spread placement that must cross the AWGR — the
locality effect behind the paper's PON results.  Each pattern's seeds
are solved together by solve_fast_batch (the adaptive driver over one
block-diagonal LP).

Run:  PYTHONPATH=src python examples_torch/pattern_sweep.py [--device cpu]
          [--backend pallas]
"""
import argparse

import numpy as np

from repro_torch.core import solver, timeslot, topology, traffic
from repro_torch.device import resolve


def run(device="cuda", backend="xla", *, topo="pon3", n_seeds=4,
        patterns=("uniform", "packed", "local"), n_map=4, n_reduce=3,
        total_gbits=6.0, iters=2000) -> dict:
    """Solve and print each pattern's seeds; returns the printed numbers
    by pattern, and under "results" each (problem, result)."""
    device = resolve(device)
    topo = topology.build(topo)
    seeds = range(n_seeds)
    out: dict = {"results": []}
    print(f"{topo.name}: {n_map}x{n_reduce} tasks, {total_gbits:g} Gbit "
          f"shuffle, {len(seeds)} seeds\n")
    for pat_name in patterns:
        pat = traffic.pattern(pat_name, n_map=n_map, n_reduce=n_reduce,
                              total_gbits=total_gbits)
        probs = [timeslot.ScheduleProblem(
                     topo, cf, n_slots=timeslot.suggest_n_slots(topo, cf),
                     path_slack=2)
                 for cf in traffic.generate_batch(topo, pat, seeds)]
        results = solver.solve_fast_batch(probs, "energy", iters=iters,
                                          backend=backend, device=device)
        e = np.array([r.metrics.energy_j for r in results])
        m = np.array([r.metrics.completion_s for r in results])
        feasible = all(r.metrics.feasible for r in results)
        print(f"  {pat_name:8s} E = {e.mean():7.1f} ± {e.std():5.1f} J   "
              f"M = {m.mean():.3f} ± {m.std():.3f} s   "
              f"feasible = {feasible}")
        out[pat_name] = {"energy_j": e.tolist(), "completion_s": m.tolist(),
                         "feasible": feasible}
        out["results"] += list(zip(probs, results))
    print("\nFull grid: PYTHONPATH=src python -m repro_torch.sweep --topos all "
          "--objectives energy,completion --patterns uniform,skew,packed "
          "--seeds 8")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("xla", "pallas"), default="xla")
    args = ap.parse_args(argv)
    return run(args.device, args.backend)


if __name__ == "__main__":
    main()
