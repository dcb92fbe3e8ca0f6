"""The benchmark harness: one cell of BENCHMARK.json, run once.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own, found by name:

  configs/<config>.json     a deployment: topology builder and arguments
  topologies/<builder>.py   that builder, as plain arrays
  traffic/<mix>.json        a mix: the driver it runs and its parameters
  drivers/<entry>.py        a driver: set-up, the measured window, and
                            what the reference judges afterwards
  metrics/<metric>.py       a per-layer metric's reader over the traced
                            window's spans, counters and device trace
  limits/<workload>.json    the limits the cell's outputs are held to,
                            beside the configuration's stated tolerances

The program under test is the PyTorch/CUDA package `repro_torch` (from
the checkout's src/); the reference (reference/) and everything here
import nothing of it but what `program()` hands a driver."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import random
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

# published peaks (NVIDIA's data sheet, SXM part; at its 700 W limit)
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_s": 3.35e12,
                                   "fp32_ops_s": 67e12}}


def load_file(path: pathlib.Path):
    """Import a file of the benchmark by its path (its name may hold dots
    or dashes) as portbench_<stem>."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace("-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json
    mix: dict               # traffic/<mix>.json
    limits: dict            # limits/<workload>.json
    end_to_end: list        # BENCHMARK.json's entries this cell reports
    per_layer: list


def find_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return cell_from_files(workload, root / conf["file"], w["traffic"],
                           int(w["chips"]), bench)


def cell_from_files(workload: str, config_file: pathlib.Path, traffic: str,
                    chips: int = 1, bench: dict | None = None) -> Cell:
    """A cell from its files; its metrics are the entries of `bench`
    (BENCHMARK.json's) that it reports, none without."""
    bench = bench or {"end_to_end": [], "per_layer": []}
    config = load_json(config_file)
    # the configuration's stated tolerances, then the cell's own limits
    limits = {k: v for k, v in config["guarantees"].items()
              if isinstance(v, float)}
    limits.update(load_json(HERE / "limits" / f"{workload}.json"))

    def mine(entry):
        return workload in entry.get("workloads", [workload])
    return Cell(name=workload, chips=chips, config=config,
                mix=load_json(HERE / "traffic" / f"{traffic}.json"),
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def topology_arrays(config: dict) -> dict:
    builder = load_file(HERE / "topologies" / f"{config['builder']}.py")
    return builder.build(**config["args"])


def program():
    """The program's modules a driver may call: the system under test."""
    import repro_torch.core.solver as solver
    import repro_torch.core.timeslot as timeslot
    import repro_torch.core.topology as topology
    import repro_torch.core.traffic as traffic
    import repro_torch.core.verify as verify
    import repro_torch.kernels.ops as ops
    return dataclasses.make_dataclass("Program", [
        "solver", "timeslot", "topology", "traffic", "verify", "ops"])(
        solver, timeslot, topology, traffic, verify, ops)


def program_topology(P, arrays: dict):
    """The benchmark's topology arrays in the program's Topology type."""
    devices = [P.topology.Device(n, k, float(p), float(e))
               for n, k, p, e in zip(arrays["names"], arrays["kinds"],
                                     arrays["p_max"], arrays["eps"])]
    sigma = {int(i): float(s) for i, s in enumerate(arrays["sigma"])
             if np.isfinite(s)}
    return P.topology.Topology(
        name=arrays["name"], devices=devices,
        edges=arrays["edges"].astype(np.int32),
        cap=arrays["cap"].astype(np.float64),
        n_wavelengths=int(arrays["cap"].shape[1]),
        slot_duration=float(arrays["slot_duration"]),
        task_servers=[i for i, k in enumerate(arrays["kinds"])
                      if k == "server"],
        server_relay=bool(arrays["server_relay"]),
        one_wavelength_tx=bool(arrays["one_wavelength_tx"]),
        awgr_in_ports=[int(i) for i in arrays["awgr_in"]],
        switch_sigma=sigma)


@dataclasses.dataclass
class Ctx:
    """What a driver is handed: the cell, the run's arguments, the
    program, the topology (its arrays, the reference's `Fabric` of them
    and the program's `Topology`), the spans and the counters."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    control: bool
    P: object
    arrays: dict
    fab: object
    topo: object
    spans: object
    counters: dict = dataclasses.field(default_factory=dict)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", control: bool = False,
             t_start: float | None = None,
             cell: Cell | None = None) -> dict:
    """Run one cell once; returns the result line's object with its
    checks.  `cell` overrides the files (tests run tiny cells on the
    CPU); `control` runs the program's lower-precision path."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from portbench import spans as spans_mod
    from portbench.reference import model
    cell = cell or find_cell(workload)
    random.seed(0)
    np.random.seed(0)
    torch.manual_seed(0)
    P = program()
    on_card = device != "cpu"
    split = {"imports": time.perf_counter() - t_start}
    if on_card:
        t0 = time.perf_counter()
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize()
        split["cuda start"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arrays = topology_arrays(cell.config)
    sp = spans_mod.Spans(annotate=trace and device != "cpu")
    ctx = Ctx(cell=cell, seed=int(seed), seconds=float(seconds),
              trace=trace, device=device, control=control, P=P,
              arrays=arrays, fab=model.Fabric.from_arrays(arrays),
              topo=program_topology(P, arrays), spans=sp)
    driver = load_file(HERE / "drivers" / f"{cell.mix['entry']}.py")
    split["topology"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = driver.setup(ctx)
    split["inputs and warm-up"] = time.perf_counter() - t0
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()),
          file=sys.stderr)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if trace:
        driver.instrument(ctx)
    setup_s = time.perf_counter() - t_start
    dtrace = None
    if trace and on_card:
        dtrace = spans_mod.DeviceTrace()
        with dtrace:
            window = driver.window(ctx, state)
    else:
        window = driver.window(ctx, state)
    sp.close()
    peak = (int(max(torch.cuda.max_memory_allocated(d)
                    for d in range(torch.cuda.device_count())))
            if on_card else 0)
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    window["peaks"] = PEAKS.get(kind)
    checks, extra = driver.judge(ctx, state, window)
    del state
    # what the program itself reports as failed (a plan its own
    # certificate rejects) is never correct
    checks["failed"] = {"value": float(window["failed"]), "limit": 0.0}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values())
           and window["attempted"] > 0,
           "attempted": int(window["attempted"]),
           "failed": int(window["failed"])}
    metrics = {}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": kind,
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": peak}
    if not trace:
        values = dict(window["end_to_end"], **extra, setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    else:
        read = dict(window["trace"])
        if dtrace is not None:
            got = dtrace.read(sp.self_s)
            read.update(busy_s=got["busy_s"], window_s=dtrace.window_s,
                        ops=got["ops"])
            dev.update(busy_s=got["busy_s"], window_s=dtrace.window_s)
            out["breakdown"] = {
                "device_ops": [[k, s] for k, (_, s) in sorted(
                    got["ops"].items(), key=lambda kv: -kv[1][1])[:10]],
                "idle_gaps": [[k, s] for k, s in sorted(
                    got["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]]}
        read["spans"] = dict(sp.self_s)
        for m in cell.per_layer:
            reader = load_file(HERE / "metrics" / f"{m['name']}.py")
            v = reader.read(read)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out["metrics"] = metrics
    out["device"] = dev
    out["checks"] = checks
    return out


def forbidden_modules(modules=None) -> list:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by whole top-level name."""
    modules = sys.modules if modules is None else modules
    bad = {"jax", "jaxlib", "flax", "repro"}
    return sorted(m for m in list(modules) if m.split(".")[0] in bad)
