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
                p, "energy", iters=ITERS, shards=2,
                backend="pallas", device="cpu"))
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
                                           shards=2,
                                           backend="pallas", device="cpu"))]
        from repro_torch.core import timeslot, topology, traffic
        w = convert.fast_result_from_arrays(payload["warm"])
        _, p, keep = warm_problems((topology, traffic, timeslot))
        got = solver.solve_fast_warm(p, "energy", warm=w, flow_map=keep,
                                     iters=3000, tol=2e-3, shards=2,
                                     backend="pallas", device="cpu")
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


def smoke_model(arch: str, state: dict | None, tp: int = 1):
    """The port's smoke model of `arch` with its widths padded for a
    tp-way model axis: `state` (a params_from_numpy state dict of numpy
    arrays) loaded, or drawn from seed 0 when None."""
    from repro_torch import configs
    from repro_torch.models import transformer
    cfg = configs.get(arch, smoke=True)
    model = transformer.Transformer(
        cfg, generator=torch.Generator().manual_seed(0),
        device=torch.device("cpu"), tp=tp)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
    return cfg, model


def _full(t) -> np.ndarray:
    """A DTensor's (or tensor's) whole value as fp32 numpy."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def _serve(cfg, model, batch, gen, strategy, pos0, memory=None):
    """Prefill then `gen` greedy decode steps (`memory`, the encoder's
    output, passed to an encoder-decoder model's steps): the prefill's
    logits and caches, and each step's logits and token, all as numpy."""
    from repro_torch.runtime import steps
    prefill = steps.make_prefill_step(cfg, impl="kernel", max_len=pos0 + gen,
                                      strategy=strategy)
    decode = steps.make_decode_step(cfg, impl="kernel", strategy=strategy)
    logits, caches = prefill(model, batch)
    out = {"prefill": _full(logits),
           "cache": [{k: _full(v) for k, v in c.items()
                      if isinstance(v, torch.Tensor)} for c in caches]}
    tok = torch.from_numpy(out["prefill"]).argmax(-1)
    out["steps"], out["tokens"] = [], []
    for i in range(gen):
        logits, caches = decode(model, caches, tok, pos0 + i, memory)
        out["steps"].append(_full(logits))
        tok = torch.from_numpy(out["steps"][-1]).argmax(-1)
        out["tokens"].append(tok.numpy())
    return out


def sharded_step_cases(rank: int, world: int, payload: dict) -> dict:
    """runtime.steps under a sharding strategy on this rank, for each
    case of payload (name -> case).  A case: "arch", "kind" ("2d" |
    "fsdp"), "shape" (the ("data", "model") mesh), "state" (the smoke
    model's state dict, numpy, or None for seed 0), "batch" (numpy,
    whole), "mode": "train" (one AdamW step: its metrics, every
    parameter's whole value after it, and how many parameter specs
    split some dim) or "serve" (a prefill and case["gen"] decode steps,
    `_serve`'s record).  A case with "plain": True also runs the same
    without a strategy on rank 0 alone, for comparison."""
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import transformer
    from repro_torch.runtime import sharding, steps
    from repro_torch.train import optimizer as opt
    out: dict = {}
    for name, case in payload.items():
        mesh = lmesh.make_host_mesh(case["shape"], ("data", "model"))
        st = sharding.Strategy(mesh, case["kind"], False)
        batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
        runs = {"sharded": st}
        if case.get("plain") and rank == 0:
            runs["plain"] = None
        got = {}
        for run, strategy in runs.items():
            cfg, model = smoke_model(case["arch"], case["state"],
                                     st.tp if strategy else 1)
            memory = None
            if cfg.family == "encdec" and case["mode"] == "serve":
                # the encoder's output, from the model before it is split
                with torch.no_grad():
                    memory = transformer.encode(model, batch["enc_embeds"])
            if strategy is not None:
                strategy.distribute(model)
            if case["mode"] == "train":
                state = opt.adamw_init(dict(model.named_parameters()))
                step = steps.make_train_step(
                    cfg, opt.AdamWConfig(total_steps=10), strategy=strategy)
                _, state, m = step(model, state, batch)
                got[run] = {
                    "metrics": {k: v.numpy() for k, v in m.items()},
                    "params": {k: _full(p)
                               for k, p in model.named_parameters()},
                    "m": {k: _full(v) for k, v in state["m"].items()}}
                if strategy is not None:
                    specs = strategy.specs_for(model)
                    got[run]["n_split"] = sum(
                        any(e is not None for e in s) for s in specs.values())
                    got[run]["n_params"] = len(specs)
            else:
                pos0 = batch["tokens"].shape[1] + (
                    cfg.n_img_tokens if cfg.family == "vlm" else 0)
                got[run] = _serve(cfg, model, batch, case["gen"], strategy,
                                  pos0, memory)
        out[name] = got
    return out


def mlp_layout_case(rank: int, world: int, payload: dict) -> dict:
    """phi4-mini smoke's train step under "fsdp" on a (world // 2) x 2
    ("data", "model") mesh, seed 0's parameters, payload["batch"] (numpy,
    whole).  Every DTensor product of the MLP (an operand with a d_ff
    dim) is recorded, forward and backward: each operand's global shape
    and placements.  Returns the records, the step's metrics and its
    first AdamW moments (whole), and on rank 0 the same step's without a
    strategy."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.launch import mesh as lmesh
    from repro_torch.runtime import sharding, steps
    from repro_torch.train import optimizer as opt
    batch = {k: torch.from_numpy(v) for k, v in payload["batch"].items()}

    class Products(TorchDispatchMode):
        def __init__(self, d_ff):
            super().__init__()
            self.d_ff, self.seen = d_ff, []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                ts = [a for a in args if isinstance(a, DTensor)]
                if (func._overloadpacket in (torch.ops.aten.mm,
                                             torch.ops.aten.bmm)
                        and any(self.d_ff in a.shape for a in ts)):
                    self.seen.append({
                        "backward": torch._C._current_graph_task_id() != -1,
                        "operands": [(tuple(a.shape),
                                      [repr(p) for p in a.placements])
                                     for a in ts]})
                return NotImplemented
            return func(*args, **(kwargs or {}))

    out: dict = {}
    mesh = lmesh.make_host_mesh((world // 2, 2), ("data", "model"))
    runs = {"sharded": sharding.Strategy(mesh, "fsdp", False)}
    if rank == 0:
        runs["plain"] = None
    for run, strategy in runs.items():
        cfg, model = smoke_model("phi4_mini_3_8b", None)
        if strategy is not None:
            strategy.distribute(model)
        state = opt.adamw_init(dict(model.named_parameters()))
        step = steps.make_train_step(cfg, opt.AdamWConfig(total_steps=10),
                                     strategy=strategy)
        log = Products(cfg.d_ff)
        with log:
            _, state, m = step(model, state, batch)
        out[run] = {"metrics": {k: v.numpy() for k, v in m.items()},
                    "m": {k: _full(v) for k, v in state["m"].items()},
                    "products": log.seen, "d_ff": cfg.d_ff}
    return out


def eval_after_train_case(rank: int, world: int, payload: dict) -> dict:
    """phi4-mini smoke under "2d" on a world x 1 "data" mesh, whose
    parameters each step gathers anew from their shards: a prefill
    (which caches bf16 casts of the gathered weights), one train step,
    and the prefill again; then the prefill of a fresh model that loads
    the trained parameters.  Returns the three prefills' logits."""
    from repro_torch.launch import mesh as lmesh
    from repro_torch.runtime import sharding, steps
    from repro_torch.train import optimizer as opt
    mesh = lmesh.make_host_mesh((world, 1), ("data", "model"))
    st = sharding.Strategy(mesh, "2d", False)
    batch = {k: torch.from_numpy(v) for k, v in payload.items()}
    prompt = {"tokens": batch["tokens"]}
    cfg, model = smoke_model("phi4_mini_3_8b", None)
    st.distribute(model)
    prefill = steps.make_prefill_step(cfg, impl="kernel", strategy=st)
    out = {"before": _full(prefill(model, prompt)[0])}
    state = opt.adamw_init(dict(model.named_parameters()))
    steps.make_train_step(cfg, opt.AdamWConfig(total_steps=10),
                          strategy=st)(model, state, batch)
    out["after"] = _full(prefill(model, prompt)[0])
    _, fresh = smoke_model("phi4_mini_3_8b", {
        k: _full(p) for k, p in model.named_parameters()})
    st.distribute(fresh)
    out["fresh"] = _full(prefill(fresh, prompt)[0])
    return out


# the meshes of tests/test_torch_sharding.py: name -> (axis sizes, multi_pod)
SPEC_MESHES = {"4x2": ((4, 2), ("data", "model"), False),
               "16x16": ((16, 16), ("data", "model"), False),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model"), True)}


def _jsonable(spec):
    """A spec (tuple of None | name | tuple of names) as nested lists."""
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def strategy_specs(payload: dict) -> dict:
    """The port's Strategy specs on each SPEC_MESHES mesh, each in a
    world of as many ranks on torch's "fake" backend (this process is
    rank 0; nothing is sent).  payload: "archs", "kinds", "sp" (the
    settings of sp), "batches" (batch sizes of the synthetic batches),
    "cache" ((batch, max_len) of the caches) and "queries" (mesh name ->
    kind -> arch -> list of (logical axes, shape)).  Returns, keyed
    "mesh/kind/sp/arch": every parameter's (shape, param_spec,
    compute_spec) of the model at the strategy's tp on the meta device,
    the caches' specs and shapes, the batch specs, the queries' specs and
    dryrun.count_params, all JSON-able."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import transformer
    from repro_torch.runtime import sharding, steps
    from torch.testing._internal.distributed.fake_pg import FakeStore
    meta = torch.device("meta")
    out = {}
    for mesh_name, (dims, axes, multi_pod) in SPEC_MESHES.items():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(np.prod(dims)))
        try:
            mesh = lmesh.make_host_mesh(dims, axes)
            for kind in payload["kinds"]:
                for sp in payload["sp"]:
                    st = sharding.Strategy(mesh, kind, multi_pod, sp=sp)
                    for arch in payload["archs"]:
                        cfg = configs.get(arch)
                        model = transformer.Transformer(
                            cfg, generator=torch.Generator(), device=meta,
                            tp=st.tp)
                        caches = transformer.init_cache(
                            cfg, *payload["cache"], device=meta, tp=st.tp)
                        batches = {}
                        for b in payload["batches"]:
                            for mode in ("train", "prefill"):
                                batch = steps.synthetic_batch_shapes(
                                    cfg, b, 4096, mode=mode, enc_len=16)
                                batches[f"{mode}/{b}"] = {
                                    k: _jsonable(v) for k, v in
                                    st.batch_spec(batch).items()}
                        out[f"{mesh_name}/{kind}/{sp}/{arch}"] = {
                            "params": {
                                n: (list(p.shape),
                                    _jsonable(st.param_spec(n, p.shape)),
                                    _jsonable(st.compute_spec(n, p.shape)))
                                for n, p in model.named_parameters()},
                            "caches": [
                                {k: (list(layer[k].shape), _jsonable(s))
                                 for k, s in spec.items()}
                                for layer, spec in zip(
                                    caches, st.cache_spec(caches))],
                            "batch": batches,
                            "logical": [
                                _jsonable(st.logical_to_spec(tuple(a),
                                                             tuple(s)))
                                for a, s in payload["queries"][mesh_name][
                                    kind][arch]],
                            "count": dryrun.count_params(model, cfg),
                            "tp": st.tp}
        finally:
            dist.destroy_process_group()
    return out


def dryrun_cases(out_dir: str) -> dict:
    """The dry run's cells through its CLI (repro_torch.launch.dryrun
    main, writing to out_dir): phi4-mini's train_4k and decode_32k and
    long_500k, and xlstm's long_500k, at 16 x 16; and RankCounter's
    flops of one product split over both axes of a 16 x 16 fake world
    (meta tensors), beside its global flops.  Returns the cells' JSON
    and the product's counts."""
    import json
    import pathlib
    from repro_torch.launch import dryrun
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import mesh as lmesh
    cells = {}
    for arch, shape in (("phi4_mini_3_8b", "train_4k"),
                        ("phi4_mini_3_8b", "decode_32k"),
                        ("phi4_mini_3_8b", "long_500k"),
                        ("xlstm_1_3b", "long_500k")):
        dryrun.main(["--arch", arch, "--shape", shape, "--out", out_dir])
        cells[f"{arch}/{shape}"] = json.loads(
            (pathlib.Path(out_dir) / f"{arch}_{shape}_16x16.json")
            .read_text())
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = lmesh.make_host_mesh((16, 16), ("data", "model"))
        M, K, N = 4096, 1024, 2048
        meta = torch.device("meta")
        x = distribute_tensor(torch.empty((M, K), device=meta), mesh,
                              (Shard(0), Replicate()), src_data_rank=None)
        w = distribute_tensor(torch.empty((K, N), device=meta), mesh,
                              (Replicate(), Shard(1)), src_data_rank=None)
        with dryrun.counting() as counter:
            y = x @ w
        product = {"flops": counter.flops, "global": 2 * M * K * N,
                   "local_shape": list(y.to_local().shape),
                   "collectives": counter.collective_counts,
                   "by_op": counter.flops_by_op}
    finally:
        dist.destroy_process_group()
    return {"cells": cells, "product": product}


def dryrun_mlp_products() -> list:
    """The dry run's phi4-mini x train_4k cell (16 x 16, fsdp, full
    width on meta tensors), recording every DTensor product of the MLP
    (an operand with a d_ff dim), forward and backward: each operand's
    global shape and placements."""
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.launch import dryrun
    d_ff = configs.get("phi4_mini_3_8b").d_ff
    seen = []
    counted = dryrun.RankCounter.__torch_dispatch__

    def recording(self, func, types, args=(), kwargs=None):
        ts = [a for a in args if isinstance(a, DTensor)]
        if ts and func._overloadpacket in (torch.ops.aten.mm,
                                           torch.ops.aten.bmm) \
                and any(d_ff in a.shape for a in ts):
            seen.append({
                "backward": torch._C._current_graph_task_id() != -1,
                "operands": [(tuple(a.shape), [repr(p) for p in a.placements])
                             for a in ts]})
        return counted(self, func, types, args, kwargs)

    dryrun.RankCounter.__torch_dispatch__ = recording
    try:
        res = dryrun.run_cell("phi4_mini_3_8b", "train_4k", multi_pod=False)
    finally:
        dryrun.RankCounter.__torch_dispatch__ = counted
    if not res.ok:
        raise RuntimeError(res.error)
    return seen


MOE_DRYRUN_CELLS = (("granite_moe_1b_a400m", "auto"),
                    ("granite_moe_1b_a400m", "fsdp"),
                    ("qwen2_moe_a2_7b", "auto"),
                    ("qwen2_moe_a2_7b", "fsdp"))


def _flattens_a_split_dim(t, shape) -> bool:
    """Whether viewing DTensor `t` as `shape` merges a group of dims in
    which a dim other than the group's first is sharded: the views torch
    2.11's DTensor refuses ("Attempted to flatten multiple dimensions,
    with dimension d being sharded")."""
    import math
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._ops._view_ops import Flatten, view_groups
    shape = list(shape)
    if -1 in shape:
        shape[shape.index(-1)] = t.numel() // -math.prod(shape)
    split = {p.dim for p in t.placements if isinstance(p, Shard)}
    return any(isinstance(g, Flatten)
               and any(d.input_dim in split for d in g.input_dims[1:])
               for g in view_groups(list(t.shape), shape))


def moe_dryrun_cases(n_layers: int) -> dict:
    """The dry run's MoE train_4k cells (MOE_DRYRUN_CELLS) at 16 x 16,
    full width, their configs cut to `n_layers` layers in this process
    only.  Every view, _unsafe_view and reshape the step asks of a
    DTensor (forward, remat recompute and backward) is recorded: the
    number made inside an MoE block's forward, and each one that merges
    a sharded dim other than the first of its group.  Returns each
    cell's CellResult fields with "views_in_moe" and "bad_views"."""
    import dataclasses
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models import moe
    get = configs.get
    views = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
             torch.ops.aten.reshape.default)
    seen = {"in_moe": 0, "views_in_moe": 0, "bad_views": []}
    counted = dryrun.RankCounter.__torch_dispatch__
    forward = moe.MoE.forward

    def recording(self, func, types, args=(), kwargs=None):
        if func in views and isinstance(args[0], DTensor):
            seen["views_in_moe"] += seen["in_moe"] > 0
            if _flattens_a_split_dim(args[0], args[1]):
                seen["bad_views"].append(
                    f"{func} {tuple(args[0].shape)} "
                    f"{list(args[0].placements)} -> {list(args[1])} "
                    f"(backward: {torch._C._current_graph_task_id() != -1})")
        return counted(self, func, types, args, kwargs)

    def moe_forward(self, x):
        seen["in_moe"] += 1
        try:
            return forward(self, x)
        finally:
            seen["in_moe"] -= 1

    cells = {}
    configs.get = lambda name, smoke=False: (
        get(name, smoke) if smoke
        else dataclasses.replace(get(name), n_layers=n_layers))
    dryrun.RankCounter.__torch_dispatch__ = recording
    moe.MoE.forward = moe_forward
    try:
        for arch, strategy in MOE_DRYRUN_CELLS:
            seen.update(views_in_moe=0, bad_views=[])
            res = dryrun.run_cell(arch, "train_4k", multi_pod=False,
                                  strategy_kind=strategy)
            cells[f"{arch}/{strategy}"] = {
                **dataclasses.asdict(res),
                "views_in_moe": seen["views_in_moe"],
                "bad_views": seen["bad_views"][:20]}
    finally:
        configs.get = get
        dryrun.RankCounter.__torch_dispatch__ = counted
        moe.MoE.forward = forward
    return cells


def pinned_gradient_case(store_dir: str) -> dict:
    """A gradient handed to runtime.sharding's `shard` pin with its shard
    laid out transposed, as torch 2.11's DTensor hands attention's under
    "2d", on a 1 x 1 gloo world joined through a FileStore: whether the
    gradient that reaches x has a contiguous shard, and its values."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import mesh as lmesh
    from repro_torch.runtime import sharding
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(store_dir, "store"), 1), rank=0, world_size=1)
    try:
        mesh = lmesh.make_host_mesh((1, 1), ("data", "model"))
        pl = (Shard(0), Replicate())
        x = DTensor.from_local(torch.zeros(3, 4), mesh, pl,
                               run_check=False).requires_grad_() + 0
        seen = []
        x.register_hook(seen.append)       # the gradient the pin hands on
        g = torch.arange(12.0).reshape(4, 3).t()
        sharding._Pinned.apply(x, mesh, pl).backward(
            DTensor.from_local(g, mesh, pl, run_check=False))
        got = seen[0].to_local()
        return {"given_contiguous": g.is_contiguous(),
                "contiguous": got.is_contiguous(),
                "equal": bool(torch.equal(got, g))}
    finally:
        dist.destroy_process_group()


def staged_case(rank: int, world: int, payload) -> list:
    """The collectives that chip_smoke.py's host_staged mode stages (it
    stages those of CUDA tensors; on the CPU it passes them on), as it is
    handed them inside a DTensor product split over a 1 x world mesh."""
    import importlib.util
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch import mesh as lmesh
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    mesh = lmesh.make_host_mesh((1, world), ("data", "model"))
    seen = []

    class Seeing(type(chip_smoke.host_staged())):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in self.ops:
                seen.append(str(func))
            return super().__torch_dispatch__(func, types, args, kwargs)

    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(4, 6, generator=g), torch.randn(6, 4, generator=g)
    pl = (Replicate(), Shard(1))
    da = distribute_tensor(a, mesh, pl, src_data_rank=None)
    db = distribute_tensor(b, mesh, pl, src_data_rank=None)
    with Seeing():
        c = (da @ db).full_tensor()
    return {"seen": seen, "equal": bool(torch.allclose(c, a @ b))}
