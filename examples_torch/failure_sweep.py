"""Failure scenarios on the port via the Python API (the CLI drives full
grids).

The port's counterpart of examples/failure_sweep.py.  Degrades the AWGR
PON cell and the spine-leaf DCN under the same failure presets and
compares survivability: spine-leaf servers hang off a single access link
and leaf switch, so cuts strand traffic, while PON3's wavelength-routed
AWGR core plus polymer backplanes keep every rack reachable — the
path-diversity effect the companion link-failure study (arXiv:1808.06115)
measures for MapReduce.

Each degraded instance re-solves warm-started from the healthy PDHG
state (core.solver.solve_fast_ensemble).

Run:  PYTHONPATH=src python examples_torch/failure_sweep.py [--device cpu]
          [--backend pallas]
"""
import argparse

import numpy as np

from repro_torch.core import failures, solver, timeslot, topology, traffic
from repro_torch.device import resolve


def run(device="cuda", backend="xla", *, topos=("spine-leaf", "pon3"),
        presets=("link1", "link3", "switch", "device"), n_seeds=4,
        n_map=4, n_reduce=3, total_gbits=6.0, iters=2000) -> dict:
    """Solve each topology's seeds healthy, then each preset's degraded
    instances warm; returns the printed numbers by topology and preset,
    and under "results" each (problem, result)."""
    device = resolve(device)
    kw = dict(backend=backend, device=device)
    out: dict = {"results": []}
    for topo_name in topos:
        topo = topology.build(topo_name)
        pat = traffic.pattern("uniform", n_map=n_map, n_reduce=n_reduce,
                              total_gbits=total_gbits)
        probs = [timeslot.ScheduleProblem(
                     topo, cf, n_slots=timeslot.suggest_n_slots(topo, cf),
                     path_slack=2)
                 for cf in traffic.generate_batch(topo, pat,
                                                  range(n_seeds))]
        healthy = solver.solve_fast_batch(probs, "energy", iters=iters, **kw)
        offered = np.array([p.coflow.total_gbits for p in probs])
        energy = np.mean([r.metrics.energy_j for r in healthy])
        print(f"\n{topo.name}: {n_map}x{n_reduce} tasks, {total_gbits:g} "
              f"Gbit shuffle, {n_seeds} seeds")
        print(f"  {'healthy':10s} surv = 100.0%          "
              f"E = {energy:7.1f} J")
        out[topo_name, "healthy"] = {"energy_j": energy}
        out["results"] += list(zip(probs, healthy))
        for preset in presets:
            dprobs = [failures.degrade_problem(
                          p, failures.sample(topo, preset, s))
                      for s, p in enumerate(probs)]
            results = solver.solve_fast_ensemble(dprobs, "energy",
                                                 warm=healthy, iters=iters,
                                                 **kw)
            surv = np.array([r.metrics.served.sum()
                             for r in results]) / offered
            e = np.array([r.metrics.energy_j for r in results])
            lost = np.mean([failures.degradation_ratio(topo, dp.topo)
                            for dp in dprobs])
            print(f"  {preset:10s} surv = {surv.mean():6.1%} ± "
                  f"{surv.std():5.1%}  E = {e.mean():7.1f} J   "
                  f"(capacity lost {lost:.1%})")
            out[topo_name, preset] = {"survivability": surv.tolist(),
                                      "energy_j": e.tolist(),
                                      "capacity_lost": float(lost)}
            out["results"] += list(zip(dprobs, results))
    print("\nFull grid: PYTHONPATH=src python -m repro_torch.sweep --topos "
          "all --failures link1,switch --seeds 8")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("xla", "pallas"), default="xla")
    args = ap.parse_args(argv)
    return run(args.device, args.backend)


if __name__ == "__main__":
    main()
