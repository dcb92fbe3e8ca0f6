"""The benchmark's one input generator: shuffles drawn from the run's
seed.

A MapReduce shuffle (the paper's §IV-B sort workload) places `n_map`
mappers and `n_reduce` reducers on distinct servers (`place`), and
each (mapper, reducer) pair is one flow carrying
1/n_reduce of its mapper's output.  Map outputs are equal ("uniform",
Indy GraySort) or drawn U(0, total) and rescaled to the total
("daytona", Daytona GraySort, the paper's skew).  Every stream is
numpy's default_rng keyed by (seed, stream name, index), so a run's
inputs are a pure function of its seed and no two streams collide."""
from __future__ import annotations

import zlib

import numpy as np


def rng(seed: int, stream: str, *index: int) -> np.random.Generator:
    return np.random.default_rng(
        [int(seed) % (1 << 63), zlib.crc32(stream.encode()),
         *(int(i) for i in index)])


class Sites:
    """The servers tasks may run on."""

    def __init__(self, arrays: dict):
        self.ids = np.flatnonzero(np.asarray(arrays["kinds"]) == "server")


def place(r: np.random.Generator, sites: Sites, n: int,
          placement: str) -> np.ndarray:
    """n distinct servers.  "spread", the paper's default placement:
    drawn at random from all the servers."""
    if placement != "spread":
        raise ValueError(f"placement {placement!r} is not spread")
    return sites.ids[r.permutation(len(sites.ids))[:n]]


def shuffle(r: np.random.Generator, sites: Sites, *, n_map: int,
            n_reduce: int, total_gbits: float, skew: str = "uniform",
            placement: str = "spread"):
    """(src, dst, size) of one shuffle co-flow: n_map * n_reduce flows,
    sizes in Gbits summing to total_gbits."""
    chosen = place(r, sites, n_map + n_reduce, placement)
    mappers, reducers = chosen[:n_map], chosen[n_map:]
    if skew == "daytona":
        out = r.uniform(0.0, total_gbits, size=n_map)
        out *= total_gbits / out.sum()
    elif skew == "uniform":
        out = np.full(n_map, total_gbits / n_map)
    else:
        raise ValueError(f"skew {skew!r} is neither uniform nor daytona")
    src = np.repeat(mappers, n_reduce).astype(np.int64)
    dst = np.tile(reducers, n_map).astype(np.int64)
    size = np.repeat(out / n_reduce, n_reduce).astype(np.float64)
    return src, dst, size
