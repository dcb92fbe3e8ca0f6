"""An accelerator interconnect as a co-flow scheduling domain.

A copy of the reference `repro.core.fabric` (numpy, and the port's
`solve_fast` for the plan), held to it by tests/test_torch_fabric.py.

The paper schedules MapReduce shuffle co-flows over DCN graphs.  A sharded
training step emits exactly the same object: a set of co-flows (gradient
bucket reduce-scatters, tensor-parallel all-gathers, MoE all-to-alls) over
a fabric with per-axis bandwidth (a 2-D torus within a pod plus an
inter-pod axis).

Routing on such a fabric is fixed per axis, so the paper's routing freedom
becomes *axis selection + slot packing*, and its wavelength dimension maps
to the independent axes that carry traffic simultaneously.  The fabric is
expressed in the same `Topology` schema as the six DCNs, so the identical
solver stack (core.solver fast path / core.oracle exact) produces the
collective *slot plan* a runtime executes in slot order.

Units here: GB and GB/s (the DCN side of the codebase uses Gbit/Gbps; the
two domains never mix inside one problem instance).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .solver import solve_fast
from .timeslot import ScheduleProblem
from .topology import KIND_SERVER, KIND_SWITCH, Device, Topology
from .traffic import CoflowSet

# The reference's fabric constants, copied as data: they are scheduling
# inputs of the reference's `v5e_fabric` preset (per-chip axis rates in
# GB/s and the modelled power of an active axis in W), not measurements
# of any device this package runs on.  The rates feed Topology.cap; the
# powers enter Device.p_max and are billed by core.timeslot.evaluate as
# the per-active-device ON power of eqs. (19)-(21), integrated over
# active slots into Joules by eq. (22).
ICI_GBPS_PER_LINK = 50.0
DCI_GBPS_PER_POD = 25.0
P_ICI_LINK_W = 1.5
P_DCI_LINK_W = 3.0


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """One scheduling domain: the collective channels visible to a step.

    Units: `axis_bw` in GB/s per chip, `slot_duration` in seconds — the
    derived Topology therefore ships `axis_bw * slot_duration` GB per
    slot per axis (the eq. 28 capacity bound with Gbit->GB relabeled)."""

    axis_names: tuple[str, ...]            # e.g. ("data", "model", "pod")
    axis_sizes: tuple[int, ...]            # ring lengths
    axis_bw: tuple[float, ...]             # GB/s usable per chip per axis
    slot_duration: float = 1e-3            # 1 ms scheduling slots

    def ring_factor(self, axis: int) -> float:
        """Bytes-on-wire multiplier of a ring all-reduce over this axis."""
        n = self.axis_sizes[axis]
        return 2.0 * (n - 1) / n


def v5e_fabric(multi_pod: bool = False) -> FabricSpec:
    """The reference's preset: a 16 x 16 two-axis torus, plus a two-pod
    axis when `multi_pod`."""
    if multi_pod:
        return FabricSpec(("data", "model", "pod"), (16, 16, 2),
                          (ICI_GBPS_PER_LINK, ICI_GBPS_PER_LINK,
                           DCI_GBPS_PER_POD))
    return FabricSpec(("data", "model"), (16, 16),
                      (ICI_GBPS_PER_LINK, ICI_GBPS_PER_LINK))


def fabric_topology(spec: FabricSpec) -> Topology:
    """Axis-channel graph: src -> per-axis channel -> sink.

    Each independent axis is one "switch" vertex whose ingress/egress
    capacity is the per-chip axis bandwidth (GB/s); a co-flow (collective)
    routed through axis a consumes that axis for its bytes-on-wire volume.
    This is the fixed-routing contraction of the paper's arbitrary-graph
    model: path choice collapses to axis choice.  The axis vertices carry
    `P_ICI_LINK_W`/`P_DCI_LINK_W` as their `Device.p_max`, so
    core.timeslot.evaluate bills an active axis exactly like an active
    switch under eqs. (19)-(22): p_max Watts for every slot in which any
    traffic crosses it, times the slot duration, summed into Joules."""
    devices = [Device("grads", KIND_SERVER, 0.0)]
    edges, caps = [], []
    src = 0
    for a, name in enumerate(spec.axis_names):
        ch = len(devices)
        devices.append(Device(f"axis:{name}", KIND_SWITCH,
                              P_DCI_LINK_W if name == "pod" else P_ICI_LINK_W))
        edges.append((src, ch))
        caps.append([spec.axis_bw[a]])
    sink = len(devices)
    devices.append(Device("done", KIND_SERVER, 0.0))
    for a in range(len(spec.axis_names)):
        edges.append((1 + a, sink))
        caps.append([spec.axis_bw[a]])
    return Topology(
        name="tpu-fabric", devices=devices,
        edges=np.asarray(edges, dtype=np.int32),
        cap=np.asarray(caps, dtype=np.float64),
        n_wavelengths=1, slot_duration=spec.slot_duration,
        task_servers=[src, sink], server_relay=False,
        switch_sigma={})


@dataclasses.dataclass
class Bucket:
    """One schedulable collective (e.g. a gradient bucket reduce-scatter)."""

    name: str
    bytes: float                      # payload bytes (pre ring-factor)
    allowed_axes: tuple[int, ...]     # axes this collective may use
    release_slot: int = 0             # earliest slot (backward-pass order)


@dataclasses.dataclass
class SlotPlan:
    """Executable plan: per bucket, the slot -> axis-share mapping.

    `completion_s` (seconds) and `energy_j` (Joules) are exact
    core.timeslot.evaluate numbers for the packed schedule — the
    completion-time accounting of eqs. (39)-(45) and the activity-power
    energy of eqs. (19)-(22) applied to the fabric graph — never LP
    estimates."""

    buckets: list[Bucket]
    # share[b, a, t]: fraction of bucket b's bytes sent on axis a in slot t
    share: np.ndarray
    completion_s: float
    energy_j: float
    n_slots: int

    def slot_order(self) -> list[list[int]]:
        """Bucket indices grouped by their first active slot (the order a
        runtime enforces between the collectives)."""
        first = [int(np.argmax(self.share[b].sum(axis=0) > 1e-9))
                 if self.share[b].sum() > 1e-9 else self.n_slots
                 for b in range(len(self.buckets))]
        groups: list[list[int]] = [[] for _ in range(self.n_slots)]
        for b, t in enumerate(first):
            if t < self.n_slots:
                groups[t].append(b)
        return [g for g in groups if g]


def plan_collectives(spec: FabricSpec, buckets: list[Bucket], *,
                     n_slots: int = 8, objective: str = "time",
                     iters: int = 3000,
                     device: str | torch.device = "cuda") -> SlotPlan:
    """Schedule collectives over the fabric's axes with the paper's
    scheduler.

    Each bucket becomes one co-flow src->sink; its bytes-on-wire volume is
    bytes * ring_factor(axis) — axis-dependent, which the axis-channel
    graph models by scaling the per-axis capacity by 1/ring_factor (a
    bucket 'consumes' ring_factor times its payload on an axis).

    The slot duration is sized from the workload (ideal wire time spread
    over n_slots with headroom) and doubled until the schedule is
    feasible, so the plan always ships every byte.  `device` is where the
    PDHG bursts run, as in core.solver.solve_fast ("cuda" by default,
    raising without a card; "cpu" runs the kernel's plain version)."""
    topo = fabric_topology(spec)
    A = len(spec.axis_names)
    # scale axis capacities: effective payload rate = bw / ring_factor
    # (edge a = src->axis_a, edge A+a = axis_a->sink)
    eff_bw = np.zeros(A)
    for a in range(A):
        rf = spec.ring_factor(a)
        eff_bw[a] = spec.axis_bw[a] / rf
        topo.cap[a, 0] = eff_bw[a]
        topo.cap[A + a, 0] = eff_bw[a]
    src, sink = topo.task_servers
    F = len(buckets)
    total_gb = sum(b.bytes for b in buckets) / 1e9
    ideal_s = total_gb / eff_bw.sum()
    topo.slot_duration = max(ideal_s / n_slots * 1.5, 1e-5)

    cf = CoflowSet(np.full(F, src), np.full(F, sink),
                   np.array([b.bytes / 1e9 for b in buckets]),  # GB
                   topo.n_vertices)
    release = np.array([b.release_slot for b in buckets])
    for _ in range(6):
        prob = ScheduleProblem(topo, cf, n_slots=n_slots, rho=np.inf,
                               q_weight=1e-6, release_slot=release)
        for bi, b in enumerate(buckets):       # mask disallowed axes
            for a in range(A):
                if a not in b.allowed_axes:
                    prob.flow_edge_mask[bi, a] = False
                    prob.flow_edge_mask[bi, A + a] = False
        res = solve_fast(prob, objective, iters=iters, device=device)
        if res.remaining_gbits <= 1e-6 * max(total_gb, 1.0):
            break
        topo.slot_duration *= 2.0
    else:
        raise RuntimeError("collective plan infeasible even with 32x slots")

    x = res.schedule                                               # (F,E,1,T)
    share = np.zeros((F, A, n_slots))
    for a in range(A):
        share[:, a, :] = x[:, a, 0, :]                             # src->axis edges
    tot = share.sum(axis=(1, 2), keepdims=True)
    share = np.where(tot > 1e-12, share / np.maximum(tot, 1e-12), 0.0)
    return SlotPlan(buckets=buckets, share=share,
                    completion_s=res.metrics.completion_s,
                    energy_j=res.metrics.energy_j, n_slots=n_slots)


def grad_buckets_for(layer_param_bytes: list[tuple[str, float]], *,
                     bucket_bytes: float = 64 * 2**20,
                     data_axes: tuple[int, ...] = (0,),
                     slots_per_layer: float = 0.25) -> list[Bucket]:
    """Bucket per-layer gradient bytes in backward order with staggered
    release slots (layer L-1 first)."""
    out: list[Bucket] = []
    acc = 0.0
    acc_names: list[str] = []
    n_layers = len(layer_param_bytes)
    for i, (name, nbytes) in enumerate(reversed(layer_param_bytes)):
        acc += nbytes
        acc_names.append(name)
        if acc >= bucket_bytes or i == n_layers - 1:
            out.append(Bucket(name="+".join(acc_names[-3:]), bytes=acc,
                              allowed_axes=data_axes,
                              release_slot=int(i * slots_per_layer)))
            acc, acc_names = 0.0, []
    return out
