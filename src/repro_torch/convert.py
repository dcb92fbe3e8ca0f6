"""Carry a problem, or a model's weights, across packages as plain arrays.

For the scheduler what crosses between the reference package and the
port is the problem itself and, for warm starts, a finished solve's
state.  Each `*_to_arrays` function flattens an object into a dict of
numpy arrays and Python scalars, reading only public fields, so it
accepts the reference's object as well as the port's; the matching
`*_from_arrays` rebuilds the port's object from it:

  * `problem_to_arrays` / `problem_from_arrays`: a ScheduleProblem
    (a degraded fabric included: a degraded topology is an ordinary
    Topology with smaller capacities);
  * `fast_result_to_arrays` / `fast_result_from_arrays`: a
    FastPathResult with the warm state `project_warm_start` reads
    (schedule, lp_x, lp_y, index, paths, lp_cscale) and its metrics;
  * `scenario_to_arrays` / `scenario_from_arrays`: a FailureScenario;
  * `events_to_arrays` / `events_from_arrays`: a list of ChaosEvents;
  * `trace_to_arrays` / `trace_from_arrays`: an arrival trace;
  * `placement_to_arrays` / `placement_from_arrays`: a task Placement;
  * `tenant_to_arrays` / `tenant_from_arrays`: a service TenantSpec (its
    topology, traffic pattern, arrival spec and explicit trace);
  * `service_config_to_arrays` / `service_config_from_arrays`: a
    ServiceConfig, whose `backend` becomes the port's `device`;
  * `search_result_to_arrays`: a SearchResult's placements, scores and
    counts, for comparison (there is no port object to rebuild).

For the model zoo, `params_from_numpy` turns the reference's
`transformer.init_params` tree (its leaves made numpy arrays) into a
state dict for the port's `models.transformer.Transformer`, so both
packages run the same weights and nothing is downloaded.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.arrivals import Arrival, ArrivalSpec
from .core.chaos import ChaosEvent
from .core.failures import FailureScenario
from .core.solver import FastPathResult, FlowPath, RoutingIndex
from .core.timeslot import Metrics, ScheduleProblem
from .core.topology import Device, Topology
from .core.traffic import CoflowSet, Placement, TrafficPattern
from .service.clock import SolveCostModel
from .service.loop import ServiceConfig, TenantSpec
from .models.common import ModelConfig
from .models.transformer import check_supported


def topology_to_arrays(t) -> dict:
    """Plain numpy/scalar fields of a Topology (either package's)."""
    sigma = sorted(t.switch_sigma.items())
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
    }


def topology_from_arrays(d: dict) -> Topology:
    """The port's Topology from `topology_to_arrays`' fields."""
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
    return topo


def problem_to_arrays(p) -> dict:
    """Plain numpy/scalar fields of a ScheduleProblem (either package's):
    its topology's (`topology_to_arrays`) and its own."""

    def opt(a, dtype):
        return None if a is None else np.array(a, dtype=dtype)

    return {
        **topology_to_arrays(p.topo),
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
    topo = topology_from_arrays(d)
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


def _opt_array(a, dtype=None):
    return None if a is None else np.array(a, dtype=dtype)


def _keys(keys) -> list | None:
    """Row identities as plain tuples of Python ints and strings."""
    if keys is None:
        return None
    return [tuple(k if isinstance(k, str) else int(k) for k in key)
            for key in keys]


def fast_result_to_arrays(r) -> dict:
    """Plain fields of a FastPathResult (either package's): its metrics,
    the schedule and the PDHG state a warm start projects."""
    m = r.metrics
    idx = r.index
    return {
        "schedule": _opt_array(r.schedule, np.float64),
        "metrics": {
            "energy_j": float(m.energy_j),
            "completion_s": float(m.completion_s),
            "fairness_term": float(m.fairness_term),
            "feasible": bool(m.feasible),
            "max_violation": float(m.max_violation),
            "psi": np.array(m.psi, dtype=np.float64),
            "active_devices": np.array(m.active_devices, dtype=bool),
            "served": np.array(m.served, dtype=np.float64)},
        "lp_lower_bound": float(r.lp_lower_bound),
        "lp_primal_residual": float(r.lp_primal_residual),
        "remaining_gbits": float(r.remaining_gbits),
        "lp_x": _opt_array(r.lp_x, np.float64),
        "lp_y": _opt_array(r.lp_y, np.float64),
        "index": None if idx is None else {
            "kf": np.array(idx.kf, dtype=np.int64),
            "ke": np.array(idx.ke, dtype=np.int64),
            "kw": np.array(idx.kw, dtype=np.int64),
            "n_inj": int(idx.n_inj), "n_theta": int(idx.n_theta),
            "eq_keys": _keys(idx.eq_keys), "ub_keys": _keys(idx.ub_keys)},
        "paths": None if r.paths is None else [
            {"flow": int(fp.flow),
             "triples": np.array(fp.triples, dtype=np.int64),
             "volume": float(fp.volume),
             "tx_wavelength": int(fp.tx_wavelength)} for fp in r.paths],
        "iterations": int(r.iterations),
        "lp_cscale": float(r.lp_cscale),
        "warm_started": bool(getattr(r, "warm_started", False)),
    }


def fast_result_from_arrays(d: dict) -> FastPathResult:
    """The port's FastPathResult from `fast_result_to_arrays`' fields."""
    m = d["metrics"]
    idx = d["index"]
    return FastPathResult(
        schedule=_opt_array(d["schedule"], np.float64),
        metrics=Metrics(
            energy_j=float(m["energy_j"]),
            completion_s=float(m["completion_s"]),
            fairness_term=float(m["fairness_term"]),
            feasible=bool(m["feasible"]),
            max_violation=float(m["max_violation"]),
            psi=np.array(m["psi"], dtype=np.float64),
            active_devices=np.array(m["active_devices"], dtype=bool),
            served=np.array(m["served"], dtype=np.float64)),
        lp_lower_bound=float(d["lp_lower_bound"]),
        lp_primal_residual=float(d["lp_primal_residual"]),
        remaining_gbits=float(d["remaining_gbits"]),
        lp_x=_opt_array(d["lp_x"], np.float64),
        lp_y=_opt_array(d["lp_y"], np.float64),
        index=None if idx is None else RoutingIndex(
            np.array(idx["kf"], dtype=np.int64),
            np.array(idx["ke"], dtype=np.int64),
            np.array(idx["kw"], dtype=np.int64),
            int(idx["n_inj"]), int(idx["n_theta"]),
            eq_keys=_keys(idx["eq_keys"]), ub_keys=_keys(idx["ub_keys"])),
        paths=None if d["paths"] is None else [
            FlowPath(int(fp["flow"]),
                     np.array(fp["triples"], dtype=np.int64),
                     float(fp["volume"]), int(fp["tx_wavelength"]))
            for fp in d["paths"]],
        iterations=int(d["iterations"]),
        lp_cscale=float(d["lp_cscale"]),
        warm_started=bool(d["warm_started"]))


def scenario_to_arrays(s) -> dict:
    """Plain fields of a FailureScenario (either package's)."""
    return {"name": str(s.name),
            "cut_edges": [int(e) for e in s.cut_edges],
            "failed_devices": [int(v) for v in s.failed_devices],
            "cap_scale": float(s.cap_scale),
            "edge_scale": [(int(e), float(f)) for e, f in s.edge_scale]}


def scenario_from_arrays(d: dict) -> FailureScenario:
    """The port's FailureScenario from `scenario_to_arrays`' fields."""
    return FailureScenario(
        str(d["name"]), cut_edges=tuple(int(e) for e in d["cut_edges"]),
        failed_devices=tuple(int(v) for v in d["failed_devices"]),
        cap_scale=float(d["cap_scale"]),
        edge_scale=tuple((int(e), float(f)) for e, f in d["edge_scale"]))


def events_to_arrays(events) -> list[dict]:
    """Plain fields of a list of ChaosEvents (either package's)."""
    return [{"t": float(ev.t), "kind": str(ev.kind),
             "event_id": int(ev.event_id),
             "scenario": scenario_to_arrays(ev.scenario)} for ev in events]


def events_from_arrays(rows: list[dict]) -> list[ChaosEvent]:
    """The port's ChaosEvents from `events_to_arrays`' fields."""
    return [ChaosEvent(float(r["t"]), str(r["kind"]), int(r["event_id"]),
                       scenario_from_arrays(r["scenario"])) for r in rows]


def trace_to_arrays(trace) -> list[dict]:
    """Plain fields of an arrival trace (a list of either package's
    Arrivals)."""
    return [{"t_arrive": float(a.t_arrive), "coflow_id": int(a.coflow_id),
             "src": np.array(a.coflow.src), "dst": np.array(a.coflow.dst),
             "size": np.array(a.coflow.size, dtype=np.float64),
             "n_vertices": int(a.coflow.n_vertices)} for a in trace]


def trace_from_arrays(rows: list[dict]) -> list[Arrival]:
    """The port's arrival trace from `trace_to_arrays`' fields."""
    return [Arrival(float(r["t_arrive"]),
                    CoflowSet(np.array(r["src"]), np.array(r["dst"]),
                              np.array(r["size"], dtype=np.float64),
                              int(r["n_vertices"])),
                    int(r["coflow_id"])) for r in rows]


def placement_to_arrays(pl) -> dict:
    """Plain fields of a Placement (either package's)."""
    return {"mappers": np.array(pl.mappers, dtype=np.int64),
            "reducers": np.array(pl.reducers, dtype=np.int64)}


def placement_from_arrays(d: dict) -> Placement:
    """The port's Placement from `placement_to_arrays`' fields."""
    return Placement(np.array(d["mappers"], dtype=np.int64),
                     np.array(d["reducers"], dtype=np.int64))


def _scalar_fields(obj, cls) -> dict:
    """`cls`'s dataclass fields read off `obj` (either package's)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def tenant_to_arrays(spec) -> dict:
    """Plain fields of a service TenantSpec (either package's)."""
    return {
        "name": str(spec.name), "seed": int(spec.seed),
        "objective": str(spec.objective),
        "topo": topology_to_arrays(spec.topo),
        "pattern": _scalar_fields(spec.pattern, TrafficPattern),
        "arrivals": (None if spec.arrivals is None
                     else _scalar_fields(spec.arrivals, ArrivalSpec)),
        "trace": None if spec.trace is None else trace_to_arrays(spec.trace),
    }


def tenant_from_arrays(d: dict) -> TenantSpec:
    """The port's TenantSpec from `tenant_to_arrays`' fields."""
    return TenantSpec(
        name=d["name"], topo=topology_from_arrays(d["topo"]),
        pattern=TrafficPattern(**d["pattern"]),
        arrivals=(None if d["arrivals"] is None
                  else ArrivalSpec(**d["arrivals"])),
        seed=d["seed"], objective=d["objective"],
        trace=None if d["trace"] is None else trace_from_arrays(d["trace"]))


def service_config_to_arrays(cfg) -> dict:
    """Plain fields of a ServiceConfig (either package's), the solver
    backend or device left out: the port's ServiceConfig takes `device`
    in its place."""
    out = {f.name: getattr(cfg, f.name)
           for f in dataclasses.fields(ServiceConfig)
           if f.name not in ("device", "cost")}
    out["chaos"] = tuple(str(c) for c in out["chaos"])
    out["cost"] = _scalar_fields(cfg.cost, SolveCostModel)
    return out


def service_config_from_arrays(d: dict, *,
                               device: str | torch.device = "cuda"
                               ) -> ServiceConfig:
    """The port's ServiceConfig from `service_config_to_arrays`' fields,
    on `device`."""
    return ServiceConfig(**{**d, "cost": SolveCostModel(**d["cost"])},
                         device=device)


def search_result_to_arrays(res) -> dict:
    """Plain fields of a SearchResult (either package's): the optimized
    and baseline placements with their scores, and the run's counts."""
    def cand(c):
        return {**placement_to_arrays(c.placement), "score": float(c.score)}

    return {"method": str(res.method), "objective": str(res.objective),
            "topo_name": str(res.topo_name), "best": cand(res.best),
            "baselines": {k: cand(c) for k, c in res.baselines.items()},
            "baseline_best": str(res.baseline_best),
            "gain": float(res.gain), "evaluations": int(res.evaluations),
            "dispatches": int(res.dispatches),
            "history": [float(h) for h in res.history]}


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
