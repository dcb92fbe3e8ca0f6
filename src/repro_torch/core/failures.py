"""Failure-scenario engine: degraded topologies for any of the six DCNs.

A numpy copy of the reference `repro.core.failures`: the same crc32-seeded
streams, so scenarios, degraded capacities and degraded problems are
bitwise equal to the reference's (tests/test_torch_failures.py).

The paper's grid assumes a healthy fabric; the companion study on link
failures in MapReduce DCNs (arXiv:1808.06115) shows that failures are
where path diversity actually pays off.  This module derives degraded
`Topology` instances — single/multi link cuts, device outages (ToR
switch, OLT card, AWGR port, polymer backplane), and fractional capacity
degradation — while preserving the healthy instance's device list and
edge indexing exactly:

  * a cut link / failed device only zeroes capacity rows in `cap`;
  * a brown-out scales them;
  * vertices, edges, wavelengths, and slot parameters never change.

Schema preservation is what makes the rest of the stack work unchanged:
the LP's admissible (flow, edge, wavelength) triples shrink naturally
through `edge_w_ok = cap > 0`, the evaluator/heuristics/oracle see an
ordinary Topology, and — crucially — a healthy solve's PDHG state
projects coordinate-by-coordinate onto the degraded LP, enabling the
warm-started incremental re-solves in core.solver
(`resolve_incremental`, `solve_fast_ensemble`).

Determinism: `sample(topo, preset, seed)` derives its RNG stream from
(preset name, topology name, seed) via crc32, so ensembles are
reproducible across processes and immune to PYTHONHASHSEED.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from .timeslot import ScheduleProblem, suggest_n_slots
from .topology import KIND_PASSIVE, KIND_SERVER, KIND_SWITCH, Topology
from .traffic import CoflowSet


@dataclasses.dataclass(frozen=True)
class FailureScenario:
    """A set of capacity-destroying events, applied together.

    `cut_edges` are *directed* edge row indices (closed under reversal
    for bidirectional links — use `link_groups`/`cut_links` to build
    them); `failed_devices` take down every incident edge; `cap_scale`
    multiplies every surviving capacity (fractional degradation);
    `edge_scale` applies per-edge factors (partial brown-outs)."""

    name: str
    cut_edges: tuple[int, ...] = ()
    failed_devices: tuple[int, ...] = ()
    cap_scale: float = 1.0
    edge_scale: tuple[tuple[int, float], ...] = ()

    @property
    def is_noop(self) -> bool:
        return (not self.cut_edges and not self.failed_devices
                and self.cap_scale == 1.0 and not self.edge_scale)


def apply(topo: Topology, scen: FailureScenario) -> Topology:
    """Derive the degraded Topology; devices/edges/indexing are untouched,
    only `cap` changes (never below zero)."""
    cap = topo.cap.copy()
    if scen.cap_scale != 1.0:
        cap *= scen.cap_scale
    for e, s in scen.edge_scale:
        cap[e] *= s
    if scen.cut_edges:
        cap[list(scen.cut_edges)] = 0.0
    if scen.failed_devices:
        down = np.asarray(scen.failed_devices)
        incident = (np.isin(topo.edges[:, 0], down)
                    | np.isin(topo.edges[:, 1], down))
        cap[incident] = 0.0
    name = topo.name if scen.is_noop else f"{topo.name}+{scen.name}"
    return dataclasses.replace(topo, name=name, cap=cap)


def degradation_ratio(healthy: Topology, degraded: Topology) -> float:
    """Fraction of aggregate Gbps capacity lost, in [0, 1]."""
    total = float(healthy.cap.sum())
    return 1.0 - float(degraded.cap.sum()) / max(total, 1e-12)


def affected_rows(topo: Topology, scen: FailureScenario) -> np.ndarray:
    """(E,) bool mask of the capacity rows `apply` touches for `scen`.

    A global `cap_scale` touches every row; cuts, device outages and
    per-edge brown-outs touch exactly their incident rows.  This is the
    support of the degradation — `repair` restores precisely these rows
    from the healthy topology."""
    rows = np.zeros(topo.n_edges, dtype=bool)
    if scen.cap_scale != 1.0:
        rows[:] = True
        return rows
    for e, _ in scen.edge_scale:
        rows[int(e)] = True
    if scen.cut_edges:
        rows[list(scen.cut_edges)] = True
    if scen.failed_devices:
        down = np.asarray(scen.failed_devices)
        rows |= (np.isin(topo.edges[:, 0], down)
                 | np.isin(topo.edges[:, 1], down))
    return rows


def compose(scens, name: str | None = None) -> FailureScenario:
    """Combine concurrently active scenarios into one.

    Cuts and device outages union; global scales multiply; per-edge
    brown-outs concatenate (in the given order — `apply` multiplies them
    in sequence, which is deterministic for a deterministic ordering).
    The chaos engine (core.chaos) applies the composition of the active
    set to the *pristine* topology at every state change, so repairing
    the last active failure is exact by construction."""
    scens = [s for s in scens if not s.is_noop]
    if not scens:
        return FailureScenario("none")
    if len(scens) == 1 and name is None:
        return scens[0]
    cut: list[int] = []
    dev: list[int] = []
    scale = 1.0
    edge_scale: list[tuple[int, float]] = []
    for s in scens:
        cut.extend(s.cut_edges)
        dev.extend(s.failed_devices)
        scale *= s.cap_scale
        edge_scale.extend(s.edge_scale)
    return FailureScenario(
        name or "+".join(s.name for s in scens),
        cut_edges=tuple(sorted(set(cut))),
        failed_devices=tuple(sorted(set(dev))),
        cap_scale=scale, edge_scale=tuple(edge_scale))


def repair(degraded: Topology, scen: FailureScenario,
           healthy: Topology) -> Topology:
    """Exact inverse of ``apply(healthy, scen)``.

    `apply` is lossy (a cut zeroes capacity; a brown-out multiplies in
    floating point), so the inverse restores the affected rows from the
    healthy reference instead of trying to invert arithmetic: the result
    is *bit-identical* to `healthy` — same capacity bytes, same name,
    and therefore the same solver structure-cache key.  Raises if
    `degraded` is not actually ``apply(healthy, scen)`` (rows outside
    the scenario's support differ from the healthy capacities)."""
    if degraded.n_edges != healthy.n_edges:
        raise ValueError("degraded/healthy topologies differ in shape")
    rows = affected_rows(healthy, scen)
    cap = degraded.cap.copy()
    cap[rows] = healthy.cap[rows]
    if not np.array_equal(cap, healthy.cap):
        raise ValueError(
            f"cannot repair {degraded.name!r}: capacities outside "
            f"{scen.name!r}'s support differ from {healthy.name!r} — "
            f"it is not apply(healthy, scen)")
    return dataclasses.replace(healthy, cap=healthy.cap.copy())


# ---------------------------------------------------------------------------
# Scenario constructors
# ---------------------------------------------------------------------------

def link_groups(topo: Topology) -> list[tuple[int, ...]]:
    """Directed edge rows grouped into physical links: all rows between an
    unordered vertex pair fail together (covers PON3's one-way AWGR
    paths, which simply form single-row groups)."""
    groups: dict[frozenset, list[int]] = {}
    for e, (u, v) in enumerate(topo.edges):
        groups.setdefault(frozenset((int(u), int(v))), []).append(e)
    return [tuple(rows) for rows in groups.values()]


def cut_links(topo: Topology, link_ids, name: str | None = None
              ) -> FailureScenario:
    """Cut the physical links with the given `link_groups` indices."""
    link_ids = tuple(int(i) for i in link_ids)
    groups = link_groups(topo)
    rows = tuple(r for i in link_ids for r in groups[i])
    return FailureScenario(name or f"cut{len(link_ids)}", cut_edges=rows)


def fail_device(topo: Topology, device, name: str | None = None
                ) -> FailureScenario:
    """Take a device (index or name) fully offline."""
    if isinstance(device, str):
        idx = next((i for i, d in enumerate(topo.devices)
                    if d.name == device), None)
        if idx is None:
            raise KeyError(f"no device named {device!r} in {topo.name}; "
                           f"have {[d.name for d in topo.devices]}")
        device = idx
    return FailureScenario(name or topo.devices[device].name,
                           failed_devices=(int(device),))


def degrade(topo: Topology, factor: float, name: str | None = None
            ) -> FailureScenario:
    """Scale every capacity by `factor` (0 < factor <= 1)."""
    assert 0.0 < factor <= 1.0, factor
    return FailureScenario(name or f"degrade{int(round(factor * 100))}",
                           cap_scale=factor)


def _sample_links(k: int):
    def gen(topo: Topology, rng: np.random.Generator) -> FailureScenario:
        groups = link_groups(topo)
        pick = rng.choice(len(groups), size=min(k, len(groups)),
                          replace=False)
        rows = tuple(r for i in np.sort(pick) for r in groups[int(i)])
        return FailureScenario(f"link{k}", cut_edges=rows)
    return gen


def _sample_device(kinds: tuple[str, ...], label: str):
    def gen(topo: Topology, rng: np.random.Generator) -> FailureScenario:
        cands = [i for i, d in enumerate(topo.devices) if d.kind in kinds]
        if not cands:
            cands = [i for i, d in enumerate(topo.devices)
                     if d.kind != KIND_SERVER]
        dev = int(cands[int(rng.integers(len(cands)))])
        return FailureScenario(label, failed_devices=(dev,))
    return gen


def _sample_degrade(factor: float, label: str):
    def gen(topo: Topology, rng: np.random.Generator) -> FailureScenario:
        return FailureScenario(label, cap_scale=factor)
    return gen


def _sample_brownout(frac_links: float, factor: float, label: str):
    def gen(topo: Topology, rng: np.random.Generator) -> FailureScenario:
        groups = link_groups(topo)
        k = max(1, int(round(frac_links * len(groups))))
        pick = rng.choice(len(groups), size=k, replace=False)
        scale = tuple((r, factor) for i in np.sort(pick)
                      for r in groups[int(i)])
        return FailureScenario(label, edge_scale=scale)
    return gen


# Named presets for the sweep CLI (`--failures link1,switch,...`).
# "switch" hits eq. (21) devices (ToR/leaf/spine/OLT/backplane); "device"
# may also hit passive AWGR ports (PON3's wavelength-routed core).
SCENARIOS = {
    "none": lambda topo, rng: FailureScenario("none"),
    "link1": _sample_links(1),
    "link3": _sample_links(3),
    "switch": _sample_device((KIND_SWITCH,), "switch"),
    "device": _sample_device((KIND_SWITCH, KIND_PASSIVE), "device"),
    "degrade50": _sample_degrade(0.5, "degrade50"),
    "brownout": _sample_brownout(0.25, 0.3, "brownout"),
}


def sample(topo: Topology, preset: str, seed: int) -> FailureScenario:
    """Draw one scenario from a named preset, deterministically in
    (preset, topology name, seed)."""
    if preset not in SCENARIOS:
        raise KeyError(f"unknown failure preset {preset!r}; "
                       f"have {sorted(SCENARIOS)}")
    rng = np.random.default_rng(
        [zlib.crc32(preset.encode()), zlib.crc32(topo.name.encode()),
         int(seed)])
    return SCENARIOS[preset](topo, rng)


def ensemble(topo: Topology, preset: str, seeds) -> list[FailureScenario]:
    """One scenario per seed (deterministic, see `sample`)."""
    return [sample(topo, preset, int(s)) for s in np.asarray(seeds)]


# ---------------------------------------------------------------------------
# Degraded problems
# ---------------------------------------------------------------------------

def routable_flows(p: ScheduleProblem) -> np.ndarray:
    """(F,) bool: does flow f still have an admissible src->dst route?

    Searches (vertex, arrival-wavelength) states honouring the flow-edge
    mask (eq. 46 etc.), positive capacities, and wavelength continuity at
    passive vertices — exactly the admissibility the LP uses, via the
    same traversal (core.solver._route_search)."""
    from .solver import _out_edges, _route_search
    out_edges = _out_edges(p)
    convert_ok = p.is_server | p.is_switch
    ok = np.zeros(p.coflow.n_flows, dtype=bool)
    for f in range(p.coflow.n_flows):
        trail = _route_search(
            p, out_edges, int(p.coflow.src[f]), int(p.coflow.dst[f]),
            lambda e, w, f=f: p.flow_edge_mask[f, e] and p.edge_w_ok[e, w],
            convert_ok)
        ok[f] = trail is not None
    return ok


def degrade_problem(p: ScheduleProblem, scen: FailureScenario, *,
                    n_slots: int | None = None) -> ScheduleProblem:
    """Build the degraded ScheduleProblem for a healthy one.

    Keeps the coflow's flow indexing (required by the warm-start
    projection) but zeroes the demand of flows the failure disconnected
    — their lost Gbits show up as survivability < 1 in the sweep, and
    the schedule stays exactly feasible for everything still routable.
    The horizon defaults to `suggest_n_slots` on the *degraded*
    capacities, so heavier failures automatically get longer horizons."""
    dtopo = apply(p.topo, scen)
    probe = ScheduleProblem(dtopo, p.coflow, n_slots=p.n_slots, rho=p.rho,
                            q_weight=p.q_weight,
                            release_slot=p.release_slot,
                            path_slack=p.path_slack)
    ok = routable_flows(probe)
    cf = p.coflow
    if not ok.all():
        cf = CoflowSet(cf.src, cf.dst,
                       np.where(ok, cf.size, 0.0), cf.n_vertices)
    T = n_slots or suggest_n_slots(dtopo, cf, rho=p.rho)
    return ScheduleProblem(dtopo, cf, n_slots=T, rho=p.rho,
                           q_weight=p.q_weight,
                           release_slot=p.release_slot,
                           path_slack=p.path_slack,
                           flow_weight=p.flow_weight)
