"""The paper's technique applied to a training step, on the port:

1. extract per-layer gradient-bucket co-flows for a 32-layer model;
2. schedule them over the two torus axes with the time-slotted
   scheduler (release slots = backward-pass order);
3. compare against a naive single-axis schedule;
4. re-plan around a straggling axis (derated bandwidth).

The port's counterpart of examples/coflow_schedule.py.  Each plan solves
its LP through the COO burst kernel (core.fabric.plan_collectives), in
the default lowering, the reference's COO one, as the reference's plan
does.

Run:  PYTHONPATH=src python examples_torch/coflow_schedule.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import fabric
from repro_torch.device import resolve
from repro_torch.ft import HeartbeatMonitor


def run(device="cuda", *, n_layers=32, layer_bytes=110e6,
        bucket_bytes=256e6, n_slots=12, straggler_axis=0,
        straggler_factor=0.25) -> dict:
    """Plan, compare and re-plan; returns the printed numbers, and under
    "results" the three SlotPlans (scheduled, naive, re-planned)."""
    device = resolve(device)
    spec = fabric.v5e_fabric()
    layers = [(f"layer{i}", layer_bytes) for i in range(n_layers)]
    buckets = fabric.grad_buckets_for(layers, bucket_bytes=bucket_bytes,
                                      data_axes=(0, 1))
    payload = sum(b.bytes for b in buckets)
    print(f"{len(buckets)} gradient buckets ({payload/1e9:.2f} GB payload)")

    plan = fabric.plan_collectives(spec, buckets, n_slots=n_slots,
                                   objective="time", device=device)
    naive = fabric.plan_collectives(
        spec, [fabric.Bucket(b.name, b.bytes, (0,), b.release_slot)
               for b in buckets], n_slots=n_slots, device=device)
    print(f"scheduled makespan: {plan.completion_s*1e3:7.2f} ms "
          f"(energy model {plan.energy_j:.2f} J)")
    print(f"naive single-axis : {naive.completion_s*1e3:7.2f} ms "
          f"-> {naive.completion_s/plan.completion_s:.2f}x slower")
    print("slot order (bucket indices per slot):", plan.slot_order())

    mon = HeartbeatMonitor()
    derated = mon.derated_fabric(spec, axis=straggler_axis,
                                 factor=straggler_factor)
    replan = fabric.plan_collectives(derated, buckets, n_slots=n_slots,
                                     device=device)
    shares = replan.share.sum(axis=(0, 2)) / replan.share.sum()
    print(f"\nstraggler on axis {straggler_axis} "
          f"({straggler_factor:.0%} bw): re-planned makespan "
          f"{replan.completion_s*1e3:.2f} ms; axis shares now "
          f"{np.round(shares, 2).tolist()}")
    return {"n_buckets": len(buckets), "payload_bytes": payload,
            "completion_s": plan.completion_s, "energy_j": plan.energy_j,
            "naive_completion_s": naive.completion_s,
            "slot_order": plan.slot_order(),
            "replan_completion_s": replan.completion_s,
            "axis_shares": shares.tolist(),
            "results": [plan, naive, replan]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
