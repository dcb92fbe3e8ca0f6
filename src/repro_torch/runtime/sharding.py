"""Process groups for the row-sharded PDHG solve.

The reference builds a 1-D jax Mesh over the devices one controller
sees (runtime.sharding.solver_mesh).  PyTorch has no single controller:
a sharded solve is SPMD, one process a shard, each calling the solver
with the same LP (core.solver shards=N), as `torchrun` runs them.  This
module hands the solver the group of those processes.
"""
from __future__ import annotations

import torch.distributed as dist


def solver_group(n_shards: int):
    """The process group of the `n_shards` ranks of a row-sharded PDHG
    solve: torch.distributed's default group, which must be initialized
    with a world of exactly `n_shards` ranks (rank r owns row block r).
    Raises ValueError for n_shards < 1, and naming how to launch when
    torch.distributed is not initialized or its world has another size."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    how = (f"run one process a shard: launch with torchrun "
           f"--nproc-per-node {n_shards}, or call torch.distributed."
           f"init_process_group(world_size={n_shards}, rank=...) in each "
           f"of {n_shards} processes first")
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(f"solver_group({n_shards}) needs torch.distributed "
                         f"initialized with {n_shards} ranks, and it is not "
                         f"initialized; {how}")
    world = dist.get_world_size()
    if world != n_shards:
        raise ValueError(f"solver_group({n_shards}) needs a world of "
                         f"{n_shards} ranks but torch.distributed has "
                         f"{world}; {how}")
    return dist.group.WORLD
