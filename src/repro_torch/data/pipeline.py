"""Deterministic sharded data pipeline: the port's numpy copy of
`repro.data.pipeline`, bitwise the reference's batches.

Synthetic LM stream: a fixed-seed Zipf-ish token process with enough
structure that cross-entropy falls measurably (each token depends on the
previous token and a per-sequence "topic").  Batch i is a pure function
of (seed, step, host shard), so a restart resumes mid-epoch without
coordination and every host materialises only its shard.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int                  # global batch
    seq: int
    seed: int = 0
    n_topics: int = 64
    host_id: int = 0
    n_hosts: int = 1


def _batch_at(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    local = cfg.batch // cfg.n_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
    v = cfg.vocab_size
    topic = rng.integers(0, cfg.n_topics, size=(local, 1))
    base = (topic * 97) % max(v - 257, 1)
    noise = rng.integers(0, 256, size=(local, cfg.seq + 1))
    drift = np.cumsum(rng.integers(0, 3, size=(local, cfg.seq + 1)), axis=1)
    toks = (base + noise + drift) % v
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def synthetic_stream(cfg: DataConfig, start_step: int = 0
                     ) -> Iterator[dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield _batch_at(cfg, step)
        step += 1
