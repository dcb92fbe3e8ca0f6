"""Time the row-sharded PDHG path of a checkout of this repo on one card.

    python3 tools/sharded_times.py [--root DIR]

Runs from the tree at DIR (default: the checkout holding this script), so
two trees can be timed side by side in one call on one card, in turns:

    git archive <commit> | tar -x -C _scratch/parent
    for r in _scratch/parent . . _scratch/parent; do
        python3 tools/sharded_times.py --root $r; done

On the flagship energy LP (fat-tree k=16, chip_smoke.py's FULL) it
times, at world 1 over NCCL (a FileStore, no port): the solver's sharded
restart ladder (`_solve_lp_pallas_sharded`, 4000 iterations doubled up to
3 times, three runs; the first carries the tree's one-time set-up) and
a sharded burst of 2000 iterations (ms an iteration, three runs); then
two gloo ranks sharing the card (processes of this script) each timing a
200-iteration burst of its shard (ms an iteration on the host clock,
three runs).  Prints the card's name and power limit, then one line
`RESULT {json}`.  Needs a CUDA card; the kernels build from DIR's
sources at first use.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time

LADDER = (4000, 3)          # first rung's iterations, restarts
BURST_ITERS = 2000
RANK_ITERS = 200
RUNS = 3


def _use(root: str) -> None:
    sys.path[:0] = [os.path.join(root, "src"), root]


def _flagship_lp():
    import chip_smoke as cs
    from repro_torch.core import solver
    return solver.build_routing_lp(cs.problem(*cs.FULL), "energy")[0]


def _rank(rank: int, world: int, root: str, store: str, out: str) -> None:
    """One gloo rank on cuda:0: RUNS bursts of RANK_ITERS of its shard."""
    _use(root)
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch.kernels import ops
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        op, args = cs.sharded_args(_flagship_lp(), world, dev)
        local = cs.shard_operands(op, args, rank, 1)
        kw = cs.split_kw(op, dev, RANK_ITERS, "fp32", [rank])
        ms = []
        for _ in range(RUNS):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ops.pdhg_burst_sharded(dist.group.WORLD, *local, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / RANK_ITERS)
        with open(f"{out}{rank}.json", "w") as f:
            json.dump(ms, f)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    root = os.path.abspath(ap.parse_args().root)
    _use(root)
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("sharded_times: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import solver
    from repro_torch.kernels import build, ops
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs.card_line(), flush=True)
    build.load("pdhg_burst.cu")
    lp = _flagship_lp()
    tol = 1e-4 * max(float(np.abs(lp.b).max(initial=0.0)), 1.0)
    tmp = tempfile.mkdtemp(prefix="sharded-times-")
    res: dict = {"root": root}
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "nccl"), 1), rank=0, world_size=1)
    try:
        walls = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = solver._solve_lp_pallas_sharded(lp, LADDER[0], tol,
                                                LADDER[1], None, None, 1,
                                                dev, "fp32")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        res["ladder_s"], res["ladder_iters"] = walls, r.iterations
        op, args = cs.sharded_args(lp, 1, dev)
        kw = cs.split_kw(op, dev, BURST_ITERS, "fp32")
        ms = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ops.pdhg_burst_sharded(dist.group.WORLD, *args, **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / BURST_ITERS)
        res["burst_ms_iter"] = ms
    finally:
        dist.destroy_process_group()
    out = os.path.join(tmp, "rank")
    mp.spawn(_rank, args=(2, root, os.path.join(tmp, "gloo"), out),
             nprocs=2, join=True)
    res["gloo2_ms_iter"] = []
    for r in range(2):
        with open(f"{out}{r}.json") as f:
            res["gloo2_ms_iter"].append(json.load(f))
    print("RESULT " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
