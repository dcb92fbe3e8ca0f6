"""Neighborhood moves over task Placements (repro_torch.search).

A numpy copy of the reference `repro.search.moves`, bitwise equal to it
for the same generator state (tests/test_torch_search.py).

Three structure-aware moves, all preserving the one-task-per-server
invariant (core.traffic.Placement.validate):

  * "swap"    — exchange the servers of one mapper and one reducer:
                changes flow directions without touching the server set,
                the cheapest probe of role asymmetry (ingress/egress
                capacity, eq. 46's no-relay PON constraint);
  * "migrate" — move one task to a free server in a random rack/cell:
                the only move that changes WHICH racks host work, i.e.
                the locality/energy knob (arXiv 1808.06113's
                server-centric PON gains come from exactly this);
  * "rotate"  — shift every task to the peer server in the next rack
                (cyclic over racks, same intra-rack position): a large
                coordinated step that re-lands the whole job without
                changing its shape, useful for escaping rack-local
                optima that single-task moves cannot leave.

Moves degrade gracefully: when a topology is fully occupied (no free
task server) "migrate" and unequal-rack "rotate" fall back to "swap"
instead of emitting an invalid placement.
"""
from __future__ import annotations

import numpy as np

from ..core import traffic
from ..core.topology import Topology
from ..core.traffic import Placement

MOVES = ("swap", "migrate", "rotate")


def _groups(topo: Topology) -> list[np.ndarray]:
    """Rack/cell/pod groups in deterministic (name-sorted) order."""
    g = traffic.server_groups(topo)
    return [np.asarray(g[k]) for k in sorted(g)]


def swap(pl: Placement, topo: Topology,
         rng: np.random.Generator) -> Placement:
    """Exchange the servers of one mapper and one reducer."""
    m = pl.mappers.copy()
    r = pl.reducers.copy()
    i = int(rng.integers(pl.n_map))
    j = int(rng.integers(pl.n_reduce))
    m[i], r[j] = r[j], m[i]
    return Placement(m, r)


def migrate(pl: Placement, topo: Topology,
            rng: np.random.Generator) -> Placement:
    """Move one task to a free server, preferring a random target rack."""
    used = set(pl.mappers.tolist()) | set(pl.reducers.tolist())
    free = [s for s in topo.task_servers if s not in used]
    if not free:                       # fully occupied: migration impossible
        return swap(pl, topo, rng)
    groups = _groups(topo)
    gi = int(rng.integers(len(groups)))
    free_in_rack = [s for s in groups[gi].tolist() if s in set(free)]
    target = int(rng.choice(free_in_rack if free_in_rack else free))
    k = int(rng.integers(pl.n_map + pl.n_reduce))
    m = pl.mappers.copy()
    r = pl.reducers.copy()
    if k < pl.n_map:
        m[k] = target
    else:
        r[k - pl.n_map] = target
    return Placement(m, r)


def rotate(pl: Placement, topo: Topology,
           rng: np.random.Generator) -> Placement:
    """Shift every task to the next rack (cyclic), same position in rack.

    With equal-size racks this is a bijection on servers; with unequal
    racks the position wraps modulo the target rack's size and
    collisions are repaired from that rack's free servers (anywhere as
    a last resort).  If the repair cannot complete, falls back to swap.
    """
    groups = _groups(topo)
    if len(groups) < 2:
        return swap(pl, topo, rng)
    where = {int(s): (gi, pi) for gi, g in enumerate(groups)
             for pi, s in enumerate(g.tolist())}
    shift = 1 + int(rng.integers(len(groups) - 1))
    taken: set[int] = set()
    pending: list[tuple[str, int, int]] = []    # (role, index, target rack)
    new = {"m": pl.mappers.copy(), "r": pl.reducers.copy()}
    for role, ids in (("m", pl.mappers), ("r", pl.reducers)):
        for k, s in enumerate(ids.tolist()):
            gi, pi = where[int(s)]
            tg = groups[(gi + shift) % len(groups)]
            cand = int(tg[pi % len(tg)])
            if cand in taken:
                pending.append((role, k, (gi + shift) % len(groups)))
            else:
                taken.add(cand)
                new[role][k] = cand
    for role, k, gi in pending:        # unequal racks: place on a free peer
        free = [s for s in groups[gi].tolist() if s not in taken]
        if not free:
            free = [s for s in topo.task_servers if s not in taken]
        if not free:
            return swap(pl, topo, rng)
        cand = int(free[int(rng.integers(len(free)))])
        taken.add(cand)
        new[role][k] = cand
    return Placement(new["m"], new["r"])


_MOVE_FNS = {"swap": swap, "migrate": migrate, "rotate": rotate}


def propose(pl: Placement, topo: Topology,
            rng: np.random.Generator) -> Placement:
    """One random neighbor of `pl` (uniform over the move set)."""
    name = MOVES[int(rng.integers(len(MOVES)))]
    return _MOVE_FNS[name](pl, topo, rng)
