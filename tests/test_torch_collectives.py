"""The port's slot-ordered gradient all-reduce (runtime.collectives) and
device meshes (launch.mesh) against the JAX package.

`bucketize` and `plan_axis_names` give the reference's answers for the
same leaves and plan.  The sync itself runs on gloo worlds of CPU
processes (tests/torch_ranks.py): on a 4 x 2 ("data", "model") mesh it
equals the plain mean over the dp axes (1e-6) for distinct per-rank
gradients, is the identity (1e-6) for replicated ones, reduces a bucket
the plan splits across both axes over both, and issues its collectives
in the plan's slot order; on one rank it is the identity bitwise.  The
reference's own multi-device check (tests/test_distributed.py) spawns
eight fake XLA devices and runs shard_map, which fails on this jax
(ROADMAP queue 3).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import fabric as r_fabric
from repro.runtime import collectives as r_rc
from repro_torch import tree
from repro_torch.core import fabric
from repro_torch.launch import mesh as lmesh
from repro_torch.runtime import collectives as rc

import torch_ranks

RTOL = 1e-6


@pytest.mark.parametrize("sizes,dtype,budget", [
    ((3, 5, 2, 7, 1), "float32", 4 * 6),
    ((4, 4, 4), "float32", 1),
    ((4, 4, 4), "float32", 1e9),
    ((1000, 3, 250, 250, 17, 4096), "bfloat16", 1024),
    ((8, 8, 8, 8, 8), "float32", 64),
])
def test_bucketize_matches_reference(sizes, dtype, budget):
    leaves = [torch.zeros(n, dtype=getattr(torch, dtype)) for n in sizes]
    rleaves = [jnp.zeros((n,), getattr(jnp, dtype)) for n in sizes]
    got = rc.bucketize(leaves, bucket_bytes=budget)
    assert got == r_rc.bucketize(rleaves, bucket_bytes=budget)
    flat = [i for b in got for i in b]
    assert sorted(flat) == list(range(len(sizes)))
    assert flat[0] == len(sizes) - 1


def _plan(mod, n_buckets, n_slots, axes=(0,)):
    spec = mod.v5e_fabric()
    buckets = [mod.Bucket(f"b{i}", 1e6, axes, min(i, 3))
               for i in range(n_buckets)]
    kw = {} if mod is r_fabric else dict(device="cpu")
    return mod.plan_collectives(spec, buckets, n_slots=n_slots, **kw)


@pytest.mark.parametrize("dp_axes", [("data",), ("data", "model"),
                                     ("model",)])
def test_plan_axis_names_matches_reference(dp_axes):
    names = ("data", "model")
    rmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), names)
    want = r_rc.plan_axis_names(_plan(r_fabric, 1, 2), rmesh, dp_axes)
    mesh = types.SimpleNamespace(mesh_dim_names=names)
    got = rc.plan_axis_names(_plan(fabric, 1, 2), mesh, dp_axes)
    assert got == want and len(got) == 2 and got[0] == dp_axes[0]


def test_meshes_refuse_the_wrong_world():
    with pytest.raises(RuntimeError, match="need 4 ranks"):
        lmesh.make_host_mesh((2, 2))
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        lmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        lmesh.make_production_mesh(multi_pod=True)


def _cases():
    """name -> (plan, bucket ids, dp axes): tests/test_distributed.py's
    plan (buckets granted axis 0, six slots) over the data axis, and one
    whose buckets may use both axes, reduced over both."""
    leaves = [leaf for _, leaf in tree.flatten(torch_ranks.grads_of(0, True))]
    ids = rc.bucketize(leaves, bucket_bytes=16)
    both = _plan(fabric, len(ids), 6, axes=(0, 1))
    return {"data": (_plan(fabric, len(ids), 6), ids, ("data",)),
            "both": (both, ids, ("data", "model"))}


@pytest.fixture(scope="module")
def cases():
    return _cases()


@pytest.fixture(scope="module")
def mesh_4x2(tmp_path_factory, cases):
    return torch_ranks.run(8, torch_ranks.collective_cases,
                           dict(shape=(4, 2), axes=("data", "model"),
                                plans=cases), tmp_path_factory.mktemp("m42"))


@pytest.fixture(scope="module")
def mesh_1(tmp_path_factory, cases):
    return torch_ranks.run(1, torch_ranks.collective_cases,
                           dict(shape=(1, 1), axes=("data", "model"),
                                plans=cases), tmp_path_factory.mktemp("m1"))


def _peers(ranks, rank, dp_axes):
    """The ranks whose coordinates differ from `rank`'s only on dp axes."""
    axes = ("data", "model")
    keep = [i for i, a in enumerate(axes) if a not in dp_axes]
    me = ranks[rank]["coord"]
    return [r for r, res in enumerate(ranks)
            if all(res["coord"][i] == me[i] for i in keep)]


@pytest.mark.parametrize("case", ["data", "both"])
def test_sync_equals_the_plain_mean(mesh_4x2, cases, case):
    dp_axes = cases[case][2]
    for r, res in enumerate(mesh_4x2):
        got, _, _ = res[case, False]
        peers = _peers(mesh_4x2, r, dp_axes)
        assert len(peers) == (4 if dp_axes == ("data",) else 8)
        for i, leaf in enumerate(got):
            want = np.mean([mesh_4x2[p][case, False][2][i] for p in peers],
                           axis=0, dtype=np.float64)
            np.testing.assert_allclose(leaf, want, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("case", ["data", "both"])
def test_sync_of_replicated_gradients_is_the_identity(mesh_4x2, case):
    for res in mesh_4x2:
        got, _, inputs = res[case, True]
        for a, b in zip(got, inputs):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)


@pytest.mark.parametrize("case", ["data", "both"])
def test_collectives_go_out_in_slot_order(mesh_4x2, cases, case):
    plan, ids, dp_axes = cases[case]
    order = plan.slot_order()
    assert len(order) > 1            # more than one slot to order
    for res in mesh_4x2:
        for replicated in (False, True):
            issued = res[case, replicated][1]
            slots = [s for s, _, _ in issued]
            assert slots == sorted(slots)
            first = list(dict.fromkeys(b for _, b, _ in issued))
            assert first == [b for g in order for b in g]
            for s, group in enumerate(order):
                assert {b for t, b, _ in issued if t == s} == set(group)
            # every leaf of a bucket once per axis the plan grants it
            for b in range(len(ids)):
                axes = rc.bucket_axes(plan, b, ("data", "model"), dp_axes)
                got = [a for _, bb, a in issued if bb == b]
                assert got == [a for a in axes for _ in ids[b]]
    if case == "both":
        assert any(len(rc.bucket_axes(plan, b, ("data", "model"), dp_axes))
                   == 2 for b in range(len(ids)))


@pytest.mark.parametrize("case", ["data", "both"])
def test_sync_on_one_rank_is_the_identity(mesh_1, case):
    for replicated in (False, True):
        got, issued, inputs = mesh_1[0][case, replicated]
        assert issued
        for a, b in zip(got, inputs):
            assert np.array_equal(a, b)
