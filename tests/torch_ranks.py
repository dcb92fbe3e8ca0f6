"""Small torch.distributed worlds on the CPU for the port's sharded tests
(tests/test_torch_shard.py, tests/test_torch_collectives.py).

`run(world, fn, payload, out_dir)` starts `world` processes with the
spawn method, joins them over gloo through a FileStore under `out_dir`
(never a fixed TCP port: test workers run side by side), calls
fn(rank, world, payload) on each and returns the ranks' results in rank
order.  The process group and the join both have a timeout, so a hang
fails one test instead of the suite.  This module imports no JAX: the
ranks run the port alone; the tests hold their results to the reference.
"""
from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# seconds a world may take: the sharded solves of tests/test_torch_shard.py
# take about a minute alone, several under the full suite's parallel load
TIMEOUT_S = 600
PAPER_TOPOS = ("fat-tree", "spine-leaf", "bcube", "dcell", "pon3", "pon5")
# tests/test_scale.py's traffic and iterations
UNIFORM = dict(n_map=4, n_reduce=3)
ITERS = 1200
# a fixed rung on each paper topology's LP at 4 ranks (solve_fast's
# whole ladder is held at 2 ranks)
RUNG = 300


def _rank_main(rank, world, out_dir, fn, payload):
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(out_dir, "store"), world)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            result = ("ok", fn(rank, world, payload))
        finally:
            dist.destroy_process_group()
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run(world: int, fn, payload, out_dir, timeout: float = TIMEOUT_S):
    """fn(rank, world, payload) on every rank of a fresh gloo world of
    `world` processes; returns the results in rank order.  Raises with
    the rank's traceback when one fails, or when one is still running
    after `timeout` seconds (it is killed)."""
    out_dir = str(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, out_dir, fn, payload))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join()
    if hung:
        raise RuntimeError(f"ranks {hung} of {world} still ran after "
                           f"{timeout} s")
    results = []
    for r, p in enumerate(procs):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} exited with {p.exitcode} and no "
                               f"result")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"rank {r} of {world} failed:\n{value}")
        results.append(value)
    return results


def paper_problem(name: str, pattern=UNIFORM, seed: int = 0):
    """tests/test_scale.py's problem on one paper topology (the port's)."""
    from repro_torch.core import timeslot, topology, traffic
    topo = topology.build(name)
    cf = traffic.generate(topo, traffic.pattern("uniform", **pattern), seed)
    return timeslot.ScheduleProblem(
        topo, cf, n_slots=timeslot.suggest_n_slots(topo, cf))


def warm_problems(mods):
    """tests/test_torch_warm.py's healthy problem (spine-leaf, two merged
    uniform 4 x 3 co-flows of 6 Gbit) and its sub-problem (every other
    flow at half size), with the flow map, built from the module triple
    (topology, traffic, timeslot) of either package."""
    mod_topology, mod_traffic, mod_timeslot = mods
    topo = mod_topology.build("spine-leaf")
    pat = mod_traffic.pattern("uniform", n_map=4, n_reduce=3,
                              total_gbits=6.0)
    cf = mod_traffic.concat_coflows(
        [mod_traffic.generate(topo, pat, s) for s in (0, 1)],
        topo.n_vertices)
    p = mod_timeslot.ScheduleProblem(
        topo, cf, n_slots=mod_timeslot.suggest_n_slots(topo, cf),
        path_slack=2)
    keep = np.arange(0, cf.n_flows, 2)
    sub = mod_traffic.CoflowSet(cf.src[keep], cf.dst[keep],
                                0.5 * cf.size[keep], cf.n_vertices)
    sub_p = mod_timeslot.ScheduleProblem(
        topo, sub, n_slots=mod_timeslot.suggest_n_slots(topo, sub),
        path_slack=2)
    return p, sub_p, keep


def summary(p, r) -> dict:
    """What a rank reports of a FastPathResult: the paper metrics, the
    certificate, the LP iterate's digest."""
    from repro_torch.core import verify
    cert = verify.check_schedule(p, r.schedule)
    return dict(energy_j=r.metrics.energy_j,
                completion_s=r.metrics.completion_s,
                feasible=bool(r.metrics.feasible), cert_ok=bool(cert.ok),
                remaining=float(r.remaining_gbits),
                iterations=int(r.iterations),
                x=hashlib.sha256(np.ascontiguousarray(r.lp_x).tobytes())
                .hexdigest())


def shard_cases(rank: int, world: int, payload: dict) -> dict:
    """The sharded solver's cases on one rank of a `world`-rank world:
    a fixed 300-iteration rung on spine-leaf's LP, twice; at world 1 the
    sharded driver beside the fused one; above it solver_group's refusal
    of another world size; at world 2 the six paper topologies through
    solve_fast(shards=2), solve_fast_batch and a warm re-solve from the
    reference's healthy result (`payload["warm"]`,
    convert.fast_result_to_arrays's arrays); at world 4 a fixed RUNG on
    each paper topology's LP."""
    from repro_torch import convert
    from repro_torch.core import solver
    from repro_torch.runtime import sharding
    out: dict = {}
    lp, _ = solver.build_routing_lp(paper_problem("spine-leaf"), "energy")
    runs = [solver._solve_lp_pallas_sharded(lp, 300, 1e-9, 0, None, None,
                                            world, "cpu")
            for _ in range(2)]
    out["traj"] = [(r.x, r.y, r.primal_residual) for r in runs]
    if world == 1:
        fused = solver._solve_lp_ell(lp, 400, 1e-6, 0, None, None,
                                     torch.device("cpu"))
        shard = solver._solve_lp_pallas_sharded(lp, 400, 1e-6, 0, None,
                                                None, 1, "cpu")
        out["driver"] = [(r.x, r.y, float(lp.c @ r.x))
                         for r in (fused, shard)]
        return out
    try:
        sharding.solver_group(world + 1)
    except ValueError as e:
        out["group_error"] = str(e)
    for name in PAPER_TOPOS:
        p = paper_problem(name)
        if world == 2:
            out[name] = summary(p, solver.solve_fast(
                p, "energy", iters=ITERS, shards=2, device="cpu"))
        else:
            lp, _ = solver.build_routing_lp(p, "energy")
            out[name] = solver._solve_lp_pallas_sharded(
                lp, RUNG, 1e-9, 0, None, None, world, "cpu").x
    if world == 2:
        probs = [paper_problem("pon3", payload["batch_pattern"], s)
                 for s in payload["batch_seeds"]]
        out["batch"] = [summary(p, r) for p, r in zip(
            probs, solver.solve_fast_batch(probs, "energy",
                                           iters=payload["batch_iters"],
                                           shards=2, device="cpu"))]
        from repro_torch.core import timeslot, topology, traffic
        w = convert.fast_result_from_arrays(payload["warm"])
        _, p, keep = warm_problems((topology, traffic, timeslot))
        got = solver.solve_fast_warm(p, "energy", warm=w, flow_map=keep,
                                     iters=3000, tol=2e-3, shards=2,
                                     device="cpu")
        out["warm"] = dict(summary(p, got), warm_started=got.warm_started)
    return out


def grads_of(rank: int, replicated: bool) -> dict:
    """A small gradient tree: the same on every rank when `replicated`,
    else distinct per rank (numpy, seeded by the rank)."""
    rng = np.random.default_rng(0 if replicated else 1 + rank)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return {"a": t(2, 4), "b": [t(3), t(2, 2)], "c": t(5, 3), "d": t(7)}


def collective_cases(rank: int, world: int, payload: dict) -> dict:
    """make_scheduled_grad_sync on a make_host_mesh(payload["shape"],
    payload["axes"]) mesh, for each of payload["plans"] (name -> (plan,
    bucket ids, dp axes)), on distinct and on replicated gradients:
    this rank's coordinate, and per case its synced leaves (numpy, in
    tree order) and the collectives in issue order."""
    from repro_torch import tree
    from repro_torch.launch import mesh as lmesh
    from repro_torch.runtime import collectives as rc
    mesh = lmesh.make_host_mesh(payload["shape"], payload["axes"])
    out: dict = {"coord": tuple(int(c) for c in mesh.get_coordinate())}
    for name, (plan, bucket_ids, dp_axes) in payload["plans"].items():
        for replicated in (False, True):
            issued: list = []
            sync = rc.make_scheduled_grad_sync(mesh, plan, bucket_ids,
                                               dp_axes=dp_axes,
                                               issued=issued)
            grads = grads_of(rank, replicated)
            got = sync(grads)
            out[name, replicated] = (
                [leaf.numpy() for _, leaf in tree.flatten(got)], issued,
                [leaf.numpy() for _, leaf in tree.flatten(grads)])
    return out
