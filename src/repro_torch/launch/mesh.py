"""Device meshes over the ranks of a torch.distributed world.

The reference builds jax Meshes over the devices of one controller
(launch/mesh.py there).  Here a mesh is a torch DeviceMesh over the
ranks of an initialized world (one process a card, or a CPU rank over
gloo), its axes named as the reference names them.  Functions, not
module constants: importing this module touches no process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 cards a pod ("data", "model"); multi_pod stacks 2 pods
    (512 cards, ("pod", "data", "model")), one rank a card.  Raises
    RuntimeError unless the world has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if _world() != n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {_world()}; launch "
            f"{n} processes (torchrun --nnodes ... --nproc-per-node ...)")
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def make_host_mesh(shape=(2, 2), axes=("data", "model"), *,
                   device_type: str = "cpu") -> DeviceMesh:
    """A small mesh over the ranks of the world (tests, examples): the
    world must have exactly prod(shape) ranks."""
    n = math.prod(shape)
    if _world() != n:
        raise RuntimeError(f"need {n} ranks for mesh {tuple(shape)}, have "
                           f"{_world()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
