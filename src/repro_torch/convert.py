"""Carry a problem, or a model's weights, across packages as plain arrays.

For the scheduler what crosses between the reference package and the
port is the problem itself (and, for warm starts, the PDHG state, which
`core.solver.solve_lp`/`solve_fast` take as numpy `x0`/`y0`).

`problem_to_arrays` flattens a ScheduleProblem into a dict of numpy
arrays and Python scalars; `problem_from_arrays` rebuilds the port's
ScheduleProblem from it.  `problem_to_arrays` reads only public fields,
so it accepts the reference's ScheduleProblem as well — which is how a
problem the port cannot build yet (a degraded fabric, say) is handed to
it.

For the model zoo, `params_from_numpy` turns the reference's
`transformer.init_params` tree (its leaves made numpy arrays) into a
state dict for the port's `models.transformer.Transformer`, so both
packages run the same weights and nothing is downloaded.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.timeslot import ScheduleProblem
from .core.topology import Device, Topology
from .core.traffic import CoflowSet
from .models.common import ModelConfig
from .models.transformer import check_supported


def problem_to_arrays(p) -> dict:
    """Plain numpy/scalar fields of a ScheduleProblem (either package's)."""
    t = p.topo
    sigma = sorted(t.switch_sigma.items())

    def opt(a, dtype):
        return None if a is None else np.array(a, dtype=dtype)

    return {
        "name": t.name,
        "device_names": [d.name for d in t.devices],
        "device_kinds": [d.kind for d in t.devices],
        "p_max": np.array([d.p_max for d in t.devices], dtype=np.float64),
        "eps": np.array([d.eps for d in t.devices], dtype=np.float64),
        "edges": np.array(t.edges),
        "cap": np.array(t.cap, dtype=np.float64),
        "n_wavelengths": int(t.n_wavelengths),
        "slot_duration": float(t.slot_duration),
        "task_servers": [int(i) for i in t.task_servers],
        "server_relay": bool(t.server_relay),
        "one_wavelength_tx": bool(t.one_wavelength_tx),
        "awgr_in_ports": [int(i) for i in t.awgr_in_ports],
        "sigma_vertices": np.array([k for k, _ in sigma], dtype=np.int64),
        "sigma_gbps": np.array([v for _, v in sigma], dtype=np.float64),
        "src": np.array(p.coflow.src),
        "dst": np.array(p.coflow.dst),
        "size": np.array(p.coflow.size, dtype=np.float64),
        "n_vertices": int(p.coflow.n_vertices),
        "n_slots": int(p.n_slots),
        "rho": float(p.rho),
        "q_weight": float(p.q_weight),
        "release_slot": opt(p.release_slot, np.int64),
        "path_slack": None if p.path_slack is None else int(p.path_slack),
        "flow_weight": opt(p.flow_weight, np.float64),
    }


def problem_from_arrays(d: dict) -> ScheduleProblem:
    """The port's ScheduleProblem from `problem_to_arrays`' fields."""
    devices = [Device(str(n), str(k), float(pm), float(e))
               for n, k, pm, e in zip(d["device_names"], d["device_kinds"],
                                      d["p_max"], d["eps"])]
    topo = Topology(
        name=str(d["name"]), devices=devices,
        edges=np.array(d["edges"]), cap=np.array(d["cap"], dtype=np.float64),
        n_wavelengths=int(d["n_wavelengths"]),
        slot_duration=float(d["slot_duration"]),
        task_servers=[int(i) for i in d["task_servers"]],
        server_relay=bool(d["server_relay"]),
        one_wavelength_tx=bool(d["one_wavelength_tx"]),
        awgr_in_ports=[int(i) for i in d["awgr_in_ports"]],
        switch_sigma={int(k): float(v) for k, v in
                      zip(d["sigma_vertices"], d["sigma_gbps"])})
    if topo.cap.shape != (topo.n_edges, topo.n_wavelengths):
        raise ValueError(f"cap has shape {topo.cap.shape}, expected "
                         f"({topo.n_edges}, {topo.n_wavelengths})")
    coflow = CoflowSet(np.array(d["src"]), np.array(d["dst"]),
                       np.array(d["size"], dtype=np.float64),
                       int(d["n_vertices"]))

    def opt(key, dtype):
        return None if d.get(key) is None else np.array(d[key], dtype=dtype)

    return ScheduleProblem(
        topo, coflow, n_slots=int(d["n_slots"]), rho=float(d["rho"]),
        q_weight=float(d["q_weight"]),
        release_slot=opt("release_slot", np.int64),
        path_slack=None if d.get("path_slack") is None
        else int(d["path_slack"]),
        flow_weight=opt("flow_weight", np.float64))


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for name, leaf in tree.items():
        key = f"{prefix}{name}"
        if isinstance(leaf, dict):
            out.update(_flatten(leaf, key + "."))
        else:
            out[key] = leaf
    return out


def params_from_numpy(cfg: ModelConfig, tree: dict) -> dict:
    """A `Transformer` state dict (fp32 CPU tensors) from the reference's
    parameter tree with numpy leaves.

    The reference stacks the layers of each block-pattern slot: slot i's
    tensors `tree["groups"][i]` carry a leading group axis, and group g
    of slot i is layer g * len(block_pattern) + i; the layers left over,
    `tree["rem"][i]`, are layers n_groups * len(block_pattern) + i."""
    check_supported(cfg)
    P = len(cfg.block_pattern)
    n_groups = cfg.n_layers // P
    n_rem = cfg.n_layers - n_groups * P
    if len(tree["groups"]) != P or len(tree["rem"]) != n_rem:
        raise ValueError(f"{cfg.name}: expected {P} stacked slots and "
                         f"{n_rem} remainder layers, got "
                         f"{len(tree['groups'])} and {len(tree['rem'])}")

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {name: t(tree[name]) for name in ("embed", "final_ln", "unembed")
          if name in tree}
    for i, slot in enumerate(tree["groups"]):
        for name, stacked in _flatten(slot).items():
            if stacked.shape[0] != n_groups:
                raise ValueError(f"groups[{i}].{name} stacks "
                                 f"{stacked.shape[0]} layers, expected "
                                 f"{n_groups}")
            for g in range(n_groups):
                sd[f"blocks.{g * P + i}.{name}"] = t(stacked[g])
    for i, layer in enumerate(tree["rem"]):
        for name, leaf in _flatten(layer).items():
            sd[f"blocks.{n_groups * P + i}.{name}"] = t(leaf)
    return sd
