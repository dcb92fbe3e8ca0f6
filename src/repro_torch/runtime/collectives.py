"""Coflow-scheduled collectives: execute a core.fabric.SlotPlan as the
gradient all-reduce of a data-parallel step.

The reference runs inside shard_map and enforces the plan's slot order
with jax.lax.optimization_barrier between slot groups (XLA orders
collectives by data dependence alone).  Here the collectives are
torch.distributed all-reduces over the groups of a DeviceMesh
(launch.mesh), issued with async_op=True: every leaf of every bucket of
slot t goes out at once, and every handle of slot t is waited on before
slot t+1 issues its first.  Within a slot, a bucket is reduced over the
mesh axes the plan grants it (its share of bytes on that axis), one
axis after the other when the plan splits it across two: the 2-D ring
reduction the plan load-balances.

This is the runtime half of the paper's scheduler (core/fabric.py emits
the plan).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from .. import tree as ptree
from ..core.fabric import SlotPlan


def bucketize(leaves: Sequence[torch.Tensor], bucket_bytes: float):
    """Group leaves into buckets of ~bucket_bytes, in backward order (the
    last leaf first): the reference's indices for the same leaf sizes."""
    buckets, cur, size = [], [], 0.0
    for i, leaf in enumerate(reversed(leaves)):
        cur.append(len(leaves) - 1 - i)
        size += leaf.numel() * leaf.element_size()
        if size >= bucket_bytes:
            buckets.append(cur)
            cur, size = [], 0.0
    if cur:
        buckets.append(cur)
    return buckets


def bucket_axes(plan: SlotPlan, b: int, axis_names: Sequence[str],
                dp_axes: Sequence[str]) -> list[str]:
    """The data-parallel mesh axes bucket b is reduced over: those the
    plan gives a share of its bytes, in the plan's axis order (each
    once), or every dp axis when the plan grants none of them."""
    axes = [axis_names[a] for a in range(len(axis_names))
            if plan.share[b, a].sum() > 1e-9 and axis_names[a] in dp_axes]
    return list(dict.fromkeys(axes)) or list(dp_axes)


def scheduled_psum(leaves: list, bucket_ids: list[list[int]],
                   plan: SlotPlan, mesh, axis_names: Sequence[str],
                   dp_axes: Sequence[str], issued: list | None = None):
    """All-reduce (sum) leaves bucket by bucket in the plan's slot order
    over the groups of `mesh`; returns the reduced leaves (new tensors;
    the inputs are left as they are).  Every collective of slot t is
    waited on before slot t+1 issues; a bucket split across two axes
    reduces over the first, then the second.  `issued`, when given,
    receives (slot, bucket, axis) for each collective in issue order.
    A leaf no bucket covers is reduced plainly after the plan."""
    out: list = [None] * len(leaves)

    def start(li):
        out[li] = torch.clone(leaves[li],
                              memory_format=torch.contiguous_format)

    for slot, slot_group in enumerate(plan.slot_order()):
        pending = []
        for b in slot_group:
            axes = bucket_axes(plan, b, axis_names, dp_axes)
            for li in bucket_ids[b]:
                start(li)
                pending.append((b, li, axes))
        for stage in range(max((len(a) for _, _, a in pending), default=0)):
            handles = []
            for b, li, axes in pending:
                if stage < len(axes):
                    handles.append(dist.all_reduce(
                        out[li], group=mesh.get_group(axes[stage]),
                        async_op=True))
                    if issued is not None:
                        issued.append((slot, b, axes[stage]))
            for h in handles:
                h.wait()
    for li in range(len(leaves)):
        if out[li] is None:
            start(li)
            for ax in dp_axes:
                dist.all_reduce(out[li], group=mesh.get_group(ax))
    return out


def plan_axis_names(plan: SlotPlan, mesh, dp_axes) -> list[str]:
    """The mesh axis each of the plan's fabric axes stands for: the dp
    axes first, then the mesh's axes in turn."""
    names = mesh.mesh_dim_names
    return [dp_axes[a] if a < len(dp_axes) else names[a % len(names)]
            for a in range(plan.share.shape[1])]


def make_scheduled_grad_sync(mesh, plan: SlotPlan,
                             bucket_ids: list[list[int]],
                             dp_axes: Sequence[str] = ("data",),
                             issued: list | None = None):
    """Return fn(grads) -> grads that mean-reduces a tree of gradient
    tensors (repro_torch.tree: leaves in JAX's order, which `bucket_ids`
    index) across `dp_axes` of `mesh` following the slot plan.  Each
    rank holds its own gradients (pure data parallel); every rank gets
    the mean.  `issued` as in scheduled_psum."""
    axis_names = tuple(plan_axis_names(plan, mesh, dp_axes))
    names = mesh.mesh_dim_names
    n_dp = math.prod(mesh.size(names.index(a)) for a in dp_axes)

    def sync(grads):
        flat = ptree.flatten(grads)
        reduced = scheduled_psum([leaf for _, leaf in flat], bucket_ids,
                                 plan, mesh, axis_names, dp_axes, issued)
        by_path = {path: r / n_dp for (path, _), r in zip(flat, reduced)}
        return ptree.map_with_path(lambda path, _: by_path[path], grads)

    return sync
