"""MapReduce shuffle-phase co-flow traffic models (paper §IV-B).

A numpy copy of the reference `repro.core.traffic`: the same seeded
`np.random.Generator` streams, so equal seeds give bitwise-equal co-flow
sets in both packages (tests/test_torch_problem.py).

A sort workload (identity mappers, GraySort-style) shuffles the full
intermediate dataset from the map servers to the reduce servers; each
(mapper, reducer) pair is one flow.  The paper's headline sweeps vary
three things, all captured by :class:`TrafficPattern`:

  * task placement — where the map/reduce tasks land on the topology:
      - "spread":  seeded-random over all task servers (the paper's
                   default random allocation),
      - "packed":  tasks packed rack-by-rack / cell-by-cell (grouped
                   placement, maximizing rack locality of each role),
      - "local":   mappers and reducers co-located inside the same
                   racks/PON cells (maximizing intra-cell shuffle
                   traffic — the regime where the AWGR/backplane
                   fabrics shine);
  * map-output skew — flow sizes:
      - "uniform": every map output is total/n_map (Indy GraySort),
      - "daytona": map output sizes ~ U(0, total), rescaled so they
                   sum to `total_gbits` (Daytona GraySort, Fig. 6);
  * scale — (n_map, n_reduce, total_gbits).

`generate_batch` materializes one CoflowSet per seed with identical
flow count and topology, which is exactly the shape the batched PDHG
solve (core.solver.solve_fast_batch) stacks into fused dispatches.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from .topology import Topology

PLACEMENTS = ("spread", "packed", "local")
SKEWS = ("uniform", "daytona")

# Seeding schemes for `generate`/`generate_batch`:
#   * "hierarchical" (default): np.random.default_rng([seed, TRAFFIC_TAG])
#     — the same keyed SeedSequence convention core.arrivals uses
#     (default_rng([seed, tag, k])), so the traffic stream for seed s can
#     never collide with another module's stream for the same small
#     integer seed.  The flat legacy scheme DID collide: generate(seed=s)
#     and any other module calling default_rng(s) drew identical bits
#     (core.arrivals itself re-enters generate with derived co-flow
#     seeds, which under the flat scheme replayed sweep seeds 0..N-1
#     whenever a derived seed landed in that range).
#   * "legacy": flat np.random.default_rng(seed) — bit-compatible with
#     the historical results; `shuffle_traffic` pins this scheme so its
#     documented seed-stability guarantee keeps holding.
# the reference package's tag, so both packages draw the same streams
TRAFFIC_TAG = zlib.crc32(b"repro.core.traffic")
RNG_SCHEMES = ("hierarchical", "legacy")
DEFAULT_RNG_SCHEME = "hierarchical"


def _traffic_rng(seed: int, rng_scheme: str = DEFAULT_RNG_SCHEME
                 ) -> np.random.Generator:
    """The seeded generator for one traffic instance (see RNG_SCHEMES)."""
    if rng_scheme == "legacy":
        return np.random.default_rng(int(seed))
    if rng_scheme != "hierarchical":
        raise ValueError(f"rng_scheme {rng_scheme!r} not in {RNG_SCHEMES}")
    return np.random.default_rng([int(seed), TRAFFIC_TAG])


@dataclasses.dataclass(frozen=True)
class CoflowSet:
    """A co-flow: all flows must complete before the job advances."""

    src: np.ndarray        # (F,) vertex ids
    dst: np.ndarray        # (F,) vertex ids
    size: np.ndarray       # (F,) Gbits
    n_vertices: int

    @property
    def n_flows(self) -> int:
        return int(self.src.shape[0])

    @property
    def total_gbits(self) -> float:
        return float(self.size.sum())


@dataclasses.dataclass(frozen=True)
class TrafficPattern:
    """One point of the paper's traffic grid (placement x skew x scale).

    `total_gbits` is the whole shuffle volume in **Gbits** (the paper's
    unit; divide by 8 for GB), split evenly across `n_map` map outputs
    ("uniform") or ~U(0, total) rescaled ("daytona"), then fanned out
    1/n_reduce to each reducer — so every instance has exactly
    F = n_map * n_reduce flows.  Placement/size draws are fully
    determined by the seed passed to `generate`/`generate_batch`
    (numpy default_rng; no global RNG state is read or written)."""

    name: str = "uniform"
    placement: str = "spread"
    skew: str = "uniform"
    n_map: int = 10
    n_reduce: int = 6
    total_gbits: float = 30.0

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement {self.placement!r} not in {PLACEMENTS}")
        if self.skew not in SKEWS:
            raise ValueError(f"skew {self.skew!r} not in {SKEWS}")
        if self.n_map < 1 or self.n_reduce < 1:
            raise ValueError(f"need n_map >= 1 and n_reduce >= 1, got "
                             f"n_map={self.n_map}, n_reduce={self.n_reduce}")
        if not (np.isfinite(self.total_gbits) and self.total_gbits > 0):
            raise ValueError(f"total_gbits must be finite and > 0, "
                             f"got {self.total_gbits!r}")


# Named presets used by the sweep CLI (`--patterns uniform,skew,packed,local`).
PATTERNS: dict[str, TrafficPattern] = {
    "uniform": TrafficPattern("uniform", "spread", "uniform"),
    "skew": TrafficPattern("skew", "spread", "daytona"),
    "packed": TrafficPattern("packed", "packed", "uniform"),
    "local": TrafficPattern("local", "local", "uniform"),
}


def pattern(name: str, **overrides) -> TrafficPattern:
    """Look up a preset by name, optionally overriding scale fields."""
    if name not in PATTERNS:
        raise KeyError(f"unknown pattern {name!r}; have {sorted(PATTERNS)}")
    return dataclasses.replace(PATTERNS[name], **overrides)


def server_groups(topo: Topology) -> dict[str, list[int]]:
    """Task servers grouped by rack/cell/pod, parsed from device names.

    Every builder in core.topology names servers "srv{group}.{index}", so
    the prefix before the dot identifies the rack (PON3/PON5), cell
    (DCell), pod (fat-tree), leaf (spine-leaf) or level-0 group (BCube).
    """
    groups: dict[str, list[int]] = {}
    for i in topo.task_servers:
        name = topo.devices[i].name
        key = name.split(".")[0] if "." in name else name
        groups.setdefault(key, []).append(i)
    return groups


@dataclasses.dataclass(frozen=True)
class Placement:
    """An explicit task placement: which task server hosts each task.

    Split out of `generate` so placement becomes a first-class decision
    variable — repro.search optimizes over Placements while the routing
    LP prices each candidate.  One task per server (the paper's model):
    ids must be distinct task servers, mappers and reducers disjoint.
    """

    mappers: np.ndarray    # (n_map,) vertex ids
    reducers: np.ndarray   # (n_reduce,) vertex ids

    def __post_init__(self):
        object.__setattr__(self, "mappers",
                           np.asarray(self.mappers, dtype=np.int64))
        object.__setattr__(self, "reducers",
                           np.asarray(self.reducers, dtype=np.int64))

    @property
    def n_map(self) -> int:
        return int(self.mappers.shape[0])

    @property
    def n_reduce(self) -> int:
        return int(self.reducers.shape[0])

    def key(self) -> tuple:
        """Hashable identity (for dedup / visited sets in the search)."""
        return (tuple(self.mappers.tolist()), tuple(self.reducers.tolist()))

    def validate(self, topo: Topology) -> "Placement":
        """Check server ids and the one-task-per-server invariant."""
        allowed = set(topo.task_servers)
        for role, ids in (("mapper", self.mappers),
                          ("reducer", self.reducers)):
            bad = [int(s) for s in ids if int(s) not in allowed]
            if bad:
                raise ValueError(
                    f"{topo.name}: {role} server id(s) {bad} are not task "
                    f"servers (task servers: {sorted(allowed)})")
        both = np.concatenate([self.mappers, self.reducers])
        if len(set(both.tolist())) != both.size:
            raise ValueError(
                f"{topo.name}: placement assigns one server to several "
                f"tasks (mappers={self.mappers.tolist()}, "
                f"reducers={self.reducers.tolist()}); the model hosts "
                f"one task per server")
        return self


def _check_capacity(topo: Topology, pat: TrafficPattern, n_servers: int):
    """Over-subscription semantics: placement NEVER samples a server
    twice (one task per server); a pattern that wants more tasks than
    the topology has task servers is rejected loudly here, for every
    placement kind, before any RNG draw."""
    need = pat.n_map + pat.n_reduce
    if need > n_servers:
        raise ValueError(
            f"{topo.name}: placement {pat.placement!r} needs "
            f"n_map + n_reduce = {pat.n_map} + {pat.n_reduce} = {need} "
            f"task servers, have {n_servers}; shrink the pattern or "
            f"use a larger topology")


def sample_placement(topo: Topology, pat: TrafficPattern,
                     rng: np.random.Generator) -> Placement:
    """Draw a Placement under the pattern's placement policy.

    When `n_map + n_reduce` does not divide evenly into racks, "packed"
    leaves exactly one partial rack (whole racks fill in random order)
    and "local" keeps every touched rack dual-role except at most the
    last partial one — both are deliberate, tested semantics, not
    accidents of the walk order.
    """
    servers = np.asarray(topo.task_servers)
    _check_capacity(topo, pat, len(servers))
    need = pat.n_map + pat.n_reduce
    if pat.placement == "spread":
        perm = rng.permutation(len(servers))
        chosen = servers[perm[:need]]
        return Placement(chosen[:pat.n_map], chosen[pat.n_map:need])

    groups = [np.asarray(g) for g in server_groups(topo).values()]
    order = rng.permutation(len(groups))
    if pat.placement == "packed":
        # fill whole racks in random order: mappers first, reducers continue
        seq = np.concatenate([groups[i] for i in order])
        return Placement(seq[:pat.n_map], seq[pat.n_map:need])

    # "local": walk racks in random order, splitting each rack's servers
    # between the two roles proportionally, so mappers and their reducers
    # share racks and the shuffle stays cell-local wherever possible.
    mappers: list[int] = []
    reducers: list[int] = []
    rem_m, rem_r = pat.n_map, pat.n_reduce
    for gi in order:
        g = groups[gi].copy()
        rng.shuffle(g)
        for s in g:
            if rem_m + rem_r == 0:
                break
            if rem_r == 0 or (rem_m > 0 and
                              rem_m * pat.n_reduce >= rem_r * pat.n_map):
                mappers.append(int(s))
                rem_m -= 1
            else:
                reducers.append(int(s))
                rem_r -= 1
    return Placement(np.asarray(mappers, dtype=np.int64),
                     np.asarray(reducers, dtype=np.int64))


def _map_outputs(pat: TrafficPattern, rng: np.random.Generator) -> np.ndarray:
    if pat.skew == "daytona":
        raw = rng.uniform(0.0, pat.total_gbits, size=pat.n_map)
        return raw * (pat.total_gbits / raw.sum())
    return np.full(pat.n_map, pat.total_gbits / pat.n_map)


def generate_from_placement(topo: Topology, pat: TrafficPattern,
                            placement: Placement, *,
                            map_out: np.ndarray | None = None,
                            rng: np.random.Generator | None = None,
                            seed: int = 0,
                            rng_scheme: str = DEFAULT_RNG_SCHEME
                            ) -> CoflowSet:
    """Build the shuffle co-flow set for an explicit Placement.

    Map-output sizes come from `map_out` when given (the search loop
    pins one size vector while it varies placements, so candidates are
    comparable), else are drawn from `rng` (or a fresh seeded stream) by
    the pattern's skew.  The placement is validated against the topology
    and the pattern's task counts before any array is built."""
    placement.validate(topo)
    if placement.n_map != pat.n_map or placement.n_reduce != pat.n_reduce:
        raise ValueError(
            f"placement has {placement.n_map} mappers / "
            f"{placement.n_reduce} reducers but the pattern wants "
            f"{pat.n_map} / {pat.n_reduce}")
    if map_out is None:
        if rng is None:
            rng = _traffic_rng(seed, rng_scheme)
        map_out = _map_outputs(pat, rng)
    else:
        map_out = np.asarray(map_out, dtype=np.float64)
        if map_out.shape != (pat.n_map,):
            raise ValueError(f"map_out must have shape ({pat.n_map},), "
                             f"got {map_out.shape}")
    src = np.repeat(placement.mappers, pat.n_reduce)
    dst = np.tile(placement.reducers, pat.n_map)
    size = np.repeat(map_out / pat.n_reduce, pat.n_reduce)
    return CoflowSet(src.astype(np.int64), dst.astype(np.int64),
                     size.astype(np.float64), topo.n_vertices)


def generate(topo: Topology, pat: TrafficPattern, seed: int = 0, *,
             rng_scheme: str = DEFAULT_RNG_SCHEME) -> CoflowSet:
    """Build one shuffle co-flow set for `topo` under `pat`.

    Thin wrapper over sample_placement + generate_from_placement; the
    draw order (placement permutation first, sizes second, one stream)
    is bit-compatible with the historical monolithic implementation for
    a given generator — rng_scheme="legacy" reproduces pre-hierarchical
    results exactly (see RNG_SCHEMES)."""
    rng = _traffic_rng(seed, rng_scheme)
    placement = sample_placement(topo, pat, rng)
    return generate_from_placement(topo, pat, placement, rng=rng)


def generate_batch(topo: Topology, pat: TrafficPattern, seeds, *,
                   rng_scheme: str = DEFAULT_RNG_SCHEME) -> list[CoflowSet]:
    """One CoflowSet per seed; all share F = n_map*n_reduce flows and the
    same topology, so the resulting ScheduleProblems stack into a batched
    solve (core.solver.solve_fast_batch)."""
    return [generate(topo, pat, int(s), rng_scheme=rng_scheme)
            for s in np.asarray(seeds)]


def shuffle_traffic(topo: Topology, total_gbits: float, *,
                    n_map: int = 10, n_reduce: int = 6,
                    skew: bool = False, seed: int = 0) -> CoflowSet:
    """Legacy single-instance entry point (random-spread placement).

    Kept RNG-compatible with the original seed: placement permutation is
    drawn first, skewed sizes second, from the flat legacy stream, so
    results for a given seed are unchanged — this entry point pins
    rng_scheme="legacy" even though `generate` now defaults to the
    hierarchical scheme."""
    pat = TrafficPattern(name="skew" if skew else "uniform",
                         placement="spread",
                         skew="daytona" if skew else "uniform",
                         n_map=n_map, n_reduce=n_reduce,
                         total_gbits=total_gbits)
    return generate(topo, pat, seed, rng_scheme="legacy")


def _validate_flows(src: np.ndarray, dst: np.ndarray, size: np.ndarray,
                    n_vertices: int, what: str) -> None:
    """Constructor-time flow validation: errors name the offending flow
    index instead of surfacing later as LP infeasibility or verifier
    residuals."""
    if not (src.shape == dst.shape == size.shape) or src.ndim != 1:
        raise ValueError(
            f"{what}: src/dst/size must be equal-length 1-D arrays, got "
            f"shapes {src.shape} / {dst.shape} / {size.shape}")
    bad = np.flatnonzero((src < 0) | (src >= n_vertices)
                         | (dst < 0) | (dst >= n_vertices))
    if bad.size:
        i = int(bad[0])
        raise ValueError(
            f"{what}: flow {i} endpoints ({int(src[i])} -> {int(dst[i])}) "
            f"out of range for n_vertices={n_vertices}"
            + (f" (and {bad.size - 1} more)" if bad.size > 1 else ""))
    bad = np.flatnonzero(~np.isfinite(size) | (size < 0))
    if bad.size:
        i = int(bad[0])
        raise ValueError(
            f"{what}: flow {i} has size {size[i]!r}; sizes must be "
            f"finite and >= 0 Gbits"
            + (f" (and {bad.size - 1} more)" if bad.size > 1 else ""))


def custom_coflow(src, dst, size, n_vertices: int) -> CoflowSet:
    """Hand-built CoflowSet with constructor-time validation (endpoint
    range, finite non-negative sizes, matching lengths)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    size = np.asarray(size, dtype=np.float64)
    _validate_flows(src, dst, size, n_vertices, "custom_coflow")
    return CoflowSet(src, dst, size, n_vertices)


def empty_coflow(n_vertices: int) -> CoflowSet:
    """A CoflowSet with zero flows (an arrival epoch with no work).

    The whole solver stack accepts it: build_routing_lp produces an
    empty (or theta-only) LP, solve_fast returns an all-zero schedule,
    and evaluate scores it feasible with E = M = 0."""
    z = np.zeros(0, dtype=np.int64)
    return CoflowSet(z, z, np.zeros(0, dtype=np.float64), n_vertices)


def concat_coflows(sets: list[CoflowSet], n_vertices: int) -> CoflowSet:
    """Concatenate co-flow sets into one (flow order = input order).

    Used by the rolling-horizon driver (core.arrivals) to merge carried
    residual flows with newly arrived co-flows; also handy for scoring a
    whole arrival trace as one offline instance."""
    if not sets:
        return empty_coflow(n_vertices)
    for k, s in enumerate(sets):
        if s.n_vertices != n_vertices:
            raise ValueError(
                f"concat_coflows: set {k} was built for "
                f"n_vertices={s.n_vertices}, expected {n_vertices}")
        _validate_flows(s.src, s.dst, s.size, n_vertices,
                        f"concat_coflows[set {k}]")
    return CoflowSet(
        np.concatenate([s.src for s in sets]).astype(np.int64),
        np.concatenate([s.dst for s in sets]).astype(np.int64),
        np.concatenate([s.size for s in sets]).astype(np.float64),
        n_vertices)
