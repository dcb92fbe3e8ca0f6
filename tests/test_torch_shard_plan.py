"""The row-sharded burst plan (kernels.ops.ShardedBurst) on the CPU.

* One plan reused over a ladder of rungs equals fresh
  `pdhg_burst_sharded` calls bitwise, fp32 and bf16, at 1, 2 and 4
  shards, rungs of 0, 1, an odd and an even count of iterations; and
  both equal the lockstep plain body (`pdhg_update_burst_sharded`).
* `split_schedule` (the graph's replays and the eager tail) covers
  every burst length.
* `_solve_lp_pallas_sharded(shards=1, device="cpu")` in a one-rank gloo
  world is unchanged: bitwise the fused ladder (`_solve_lp_ell`) and a
  ladder of fresh sharded bursts.
* The plan and the wrapper still refuse malformed operands.

On the card the plan runs the split step of kernels/csrc/pdhg_burst.cu
(chip_smoke.py phase 30); here it runs the plain body.  One torch
thread, so the ladders repeat bitwise whatever the host.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import solver
from repro_torch.kernels import ops
from repro_torch.kernels import pdhg_spmv as ps

import torch_ranks

CPU = torch.device("cpu")
# the ladder's rungs: none, one, an odd and an even count of iterations
RUNGS = (0, 1, 7, 12)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lp():
    return solver.build_routing_lp(torch_ranks.paper_problem("spine-leaf"),
                                   "energy")[0]


def _operands(lp, shards):
    """(op, the 12 fixed operands of a plan, x0, y0): the solver's
    sharded packing of `lp`, started from a seeded point in the box."""
    xmax = np.where(np.isfinite(lp.xmax), lp.xmax, 1e12)
    cscale = max(float(np.abs(lp.c).max(initial=0.0)), 1e-12)
    op, vecs, ell = solver._pack_pallas_sharded(
        lp.c / cscale, lp.row, lp.col, lp.val, lp.b, lp.h, xmax, lp.m_eq,
        shards, CPU)
    rng = np.random.default_rng(shards)
    x0 = np.zeros(op.n_pad, np.float32)
    x0[:lp.n] = rng.uniform(0.0, 1.0, lp.n) * np.minimum(xmax, 1.0)
    y0 = np.zeros(op.m_pad, np.float32)
    y0[:lp.m] = rng.normal(0.0, 0.1, lp.m)
    fixed = (*vecs, torch.zeros(op.n_pad, dtype=torch.bool),
             torch.zeros(op.m_pad, dtype=torch.bool), *ell)
    return op, fixed, torch.from_numpy(x0), torch.from_numpy(y0)


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_plan_reused_over_a_ladder_equals_fresh_bursts(precision, shards):
    op, fixed, x0, y0 = _operands(_lp(), shards)
    kw = dict(row_meta=op.row_meta, col_meta=op.col_meta,
              precision=precision, **ps.sharded_work(op, CPU))
    plan = ops.ShardedBurst(None, *fixed, **kw)
    got = want = (x0, y0)
    for iters in RUNGS:
        g = plan(got[0], got[1], iters)
        w = ops.pdhg_burst_sharded(None, *fixed, want[0], want[1],
                                   iters=iters, **kw)
        model = ps.pdhg_update_burst_sharded(
            want[0], want[1], *fixed, row_meta=op.row_meta,
            col_meta=op.col_meta, iters=iters, precision=precision)
        for a, b, c in zip(g, w, model):
            assert torch.equal(a, b) and torch.equal(a, c), iters
        assert g[2].shape == (op.m_pad,)
        got, want = (g[0].clone(), g[1].clone()), (w[0], w[1])
    assert bool(torch.isfinite(got[0]).all())
    assert not torch.equal(got[0], x0)       # the ladder moved x


def test_split_schedule_covers_every_burst_length():
    for iters in range(0, 257):
        pairs, tail = ops.split_schedule(iters)
        assert tail in (0, 1) and pairs >= 0
        assert 2 * pairs + tail == iters
    with pytest.raises(ValueError, match="iters must be >= 0"):
        ops.split_schedule(-1)


@pytest.fixture
def world_of_one(tmp_path):
    """A one-rank gloo world in this process, joined through a FileStore
    (no port), torn down after the test."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_one_shard_sharded_solve_on_cpu_is_unchanged(world_of_one,
                                                     precision):
    lp = _lp()
    # a ladder that climbs: a tolerance no rung meets, 2 restarts
    args = (lp, 200, 1e-12, 2, None, None)
    got = solver._solve_lp_pallas_sharded(*args, 1, CPU, precision)
    fused = solver._solve_lp_ell(*args, CPU, precision)
    assert got.iterations == fused.iterations == 200 + 400 + 800
    assert np.array_equal(got.x, fused.x) and np.array_equal(got.y, fused.y)
    assert got.primal_residual == fused.primal_residual
    assert got.duality_gap_rel == fused.duality_gap_rel
    # the same ladder of fresh sharded bursts (a new plan every rung)
    xmax = np.where(np.isfinite(lp.xmax), lp.xmax, 1e12)
    cscale = max(float(np.abs(lp.c).max(initial=0.0)), 1e-12)
    op, vecs, ell = solver._pack_pallas_sharded(
        lp.c / cscale, lp.row, lp.col, lp.val, lp.b, lp.h, xmax, lp.m_eq,
        1, CPU)
    fixed = (*vecs, torch.zeros(op.n_pad, dtype=torch.bool),
             torch.zeros(op.m_pad, dtype=torch.bool), *ell)
    x, y = torch.zeros(op.n_pad), torch.zeros(op.m_pad)
    for iters in (200, 400, 800):
        x, y, worst = ops.pdhg_burst_sharded(
            world_of_one, *fixed, x, y, row_meta=op.row_meta,
            col_meta=op.col_meta, iters=iters, precision=precision,
            **ps.sharded_work(op, CPU))
    assert np.array_equal(got.x, x.numpy()[:lp.n].astype(np.float64))
    assert np.array_equal(got.y, y.numpy()[:lp.m].astype(np.float64))
    assert got.primal_residual == float(worst.max())


def test_plan_checks_operands():
    op, fixed, x0, y0 = _operands(_lp(), 2)
    kw = dict(row_meta=op.row_meta, col_meta=op.col_meta)
    work = ps.sharded_work(op, CPU)
    size = ps.table_len(op.row_meta)
    with pytest.raises(ValueError, match="unknown precision"):
        ops.ShardedBurst(None, *fixed, **kw, precision="fp16")
    with pytest.raises(ValueError, match="row_idx must hold 2 shards"):
        ops.ShardedBurst(None, *fixed[:8], fixed[8][:size], *fixed[9:],
                         **kw)
    with pytest.raises(ValueError, match="col_work must list"):
        ops.ShardedBurst(None, *fixed, **kw, **dict(work, col_work=[]))
    with pytest.raises(ValueError, match="q must be"):
        ops.ShardedBurst(None, *fixed[:3], fixed[3][:-1], *fixed[4:], **kw)
    plan = ops.ShardedBurst(None, *fixed, **kw, **work)
    with pytest.raises(ValueError, match="iters must be >= 0"):
        plan(x0, y0, -1)
    with pytest.raises(ValueError, match="x0 must be"):
        plan(x0[:-1], y0, 1)
    with pytest.raises(ValueError, match="y0 must be"):
        plan(x0, y0.double(), 1)
    with pytest.raises(ValueError, match="iters must be >= 0"):
        ops.pdhg_burst_sharded(None, *fixed, x0, y0, **kw, iters=-1)
    # a good call after the refusals still runs
    x, y, worst = plan(x0, y0, 3)
    assert x.shape == (op.n_pad,) and y.shape == worst.shape == (op.m_pad,)
