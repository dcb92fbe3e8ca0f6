"""The port's row-sharded PDHG against the JAX package, on the CPU.

* The layout: `ell_pack_sharded` and the solver's `_pack_pallas_sharded`
  bitwise the reference's, for S in {1, 2, 4}.
* The plain body: one process stepping the S shards in lockstep against
  the reference's per-device body (`pdhg_update_burst_sharded`) under
  `jax.vmap(..., axis_name="shard")`, which sums the psum over the
  mapped axis on one CPU device: within 1e-5 of max|x| (the two sum the
  partials in different orders).  The reference's own `shard_map` path
  does not run on this jax (ROADMAP queue 3).
* Worlds of 1, 2 and 4 gloo ranks (tests/torch_ranks.py, spawned once a
  world size): x bitwise equal on every rank, to the single-process
  model, and from run to run; the world-1 sharded driver bitwise the
  fused one; the six paper topologies through solve_fast(shards=2)
  within 1e-4 of the reference's single-device `backend="pallas"`
  (Pallas in interpret mode) and certified, and a fixed rung of each at
  4 ranks within 1e-4 of the reference's, as tests/test_scale.py holds
  the reference's sharded path; solve_fast_batch and a warm re-solve at
  2 ranks within 1e-4.
* The sweep under torchrun with --mesh 2 against --mesh 1.
"""
import csv
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solver as r_solver
from repro.core import timeslot as r_timeslot
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro.kernels import pdhg_spmv as r_ps
from repro_torch import convert
from repro_torch.core import solver
from repro_torch.kernels import ops
from repro_torch.kernels import pdhg_spmv as ps
from repro_torch.runtime import sharding

import torch_ranks

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = (r_topology, r_traffic, r_timeslot)
CPU = torch.device("cpu")
RTOL = 1e-4
# the lockstep body against the reference's under vmap, of max|x|
BODY_RTOL = 1e-5
BATCH = dict(batch_pattern=dict(n_map=4, n_reduce=3, total_gbits=8.0),
             batch_seeds=(0, 1), batch_iters=2000)


def _ref_problem(name, pattern=torch_ranks.UNIFORM, seed=0):
    topo = r_topology.build(name)
    cf = r_traffic.generate(topo, r_traffic.pattern("uniform", **pattern),
                            seed)
    return r_timeslot.ScheduleProblem(
        topo, cf, n_slots=r_timeslot.suggest_n_slots(topo, cf))


def _spine_leaf_lp():
    return solver.build_routing_lp(torch_ranks.paper_problem("spine-leaf"),
                                   "energy")[0]


def _scaled(lp):
    xmax = np.where(np.isfinite(lp.xmax), lp.xmax, 1e12)
    cscale = max(float(np.abs(lp.c).max(initial=0.0)), 1e-12)
    return (lp.c / cscale, lp.row, lp.col, lp.val, lp.b, lp.h, xmax,
            lp.m_eq)


def _random_coo():
    """tests/test_scale.py's random operator: 37 x 23, 200 nonzeros."""
    rng = np.random.default_rng(0)
    m, n, nnz = 37, 23, 200
    return (rng.integers(0, m, nnz), rng.integers(0, n, nnz),
            rng.standard_normal(nnz).astype(np.float32), m, n)


def _model(lp, shards, iters, precision="fp32"):
    """The single-process model: one process stepping all S shards in
    lockstep from zero; returns (x, y, worst)."""
    op, vecs, ell = solver._pack_pallas_sharded(*_scaled(lp), shards, CPU)
    z = torch.zeros
    return ps.pdhg_update_burst_sharded(
        z(op.n_pad), z(op.m_pad), *vecs, z(op.n_pad, dtype=torch.bool),
        z(op.m_pad, dtype=torch.bool), *ell, row_meta=op.row_meta,
        col_meta=op.col_meta, iters=iters, precision=precision)


# ------------------------------------------------------------- the layout
@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("source", ["random", "spine-leaf"])
def test_ell_pack_sharded_bitwise_reference(source, shards):
    if source == "random":
        row, col, val, m, n = _random_coo()
    else:
        lp = _spine_leaf_lp()
        row, col, val, m, n = lp.row, lp.col, lp.val, lp.m, lp.n
    got = ps.ell_pack_sharded(row, col, val, m, n, shards)
    want = r_ps.ell_pack_sharded(row, col, val, m, n, shards)
    for name in ("row_idx", "row_val", "col_idx", "col_val"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert got.row_meta == want.row_meta and got.col_meta == want.col_meta
    assert (got.m_loc, got.m_pad, got.n_pad, got.shards) == (
        want.m_loc, want.m_pad, want.n_pad, want.shards)
    assert got.m_loc % 8 == 0 and got.m_pad >= m
    # each shard's work lists count its rows' and columns' entries
    row, col = np.asarray(row), np.asarray(col)
    for s in range(shards):
        mine = (row >= s * got.m_loc) & (row < (s + 1) * got.m_loc)
        assert np.array_equal(got.row_work[s].lengths, np.bincount(
            row[mine] - s * got.m_loc, minlength=got.m_loc))
        assert np.array_equal(got.col_work[s].lengths, np.bincount(
            col[mine], minlength=got.n_pad))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_pack_pallas_sharded_bitwise_reference(shards):
    lp = _spine_leaf_lp()
    op, vecs, ell = solver._pack_pallas_sharded(*_scaled(lp), shards, CPU)
    rop, rvecs, rell = r_solver._pack_pallas_sharded(*_scaled(lp), shards)
    assert op.row_meta == rop.row_meta and op.col_meta == rop.col_meta
    for got, want in zip(vecs + ell, rvecs + rell):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------- the plain body
def _reference_vmap_body(lp, shards, iters):
    """The reference's per-device body on S shards under jax.vmap with
    axis_name="shard" (psum over the mapped axis) on one CPU device."""
    rop, rvecs, rell = r_solver._pack_pallas_sharded(*_scaled(lp), shards)
    c, tau, xmax, q, sig, ub = rvecs
    m_loc = rop.m_loc

    def split(a):
        return jnp.reshape(a, (shards, -1))

    def body(q, sig, ub, keep_m, ri, rv, ci, cv, y0):
        return r_ps.pdhg_update_burst_sharded(
            jnp.zeros(rop.n_pad), y0, c, tau, xmax, q, sig, ub,
            jnp.zeros(rop.n_pad, bool), keep_m, ri, rv, ci, cv,
            row_meta=rop.row_meta, col_meta=rop.col_meta, iters=iters,
            axis="shard")

    x, y, worst = jax.vmap(body, axis_name="shard")(
        split(q), split(sig), split(ub),
        jnp.zeros((shards, m_loc), bool), *(split(a) for a in rell),
        jnp.zeros((shards, m_loc)))
    return np.asarray(x), np.asarray(y).reshape(-1), \
        np.asarray(worst).reshape(-1)


@pytest.mark.parametrize("shards", [2, 4])
def test_plain_body_tracks_reference_under_vmap(shards):
    lp = _spine_leaf_lp()
    rx, ry, rworst = _reference_vmap_body(lp, shards, 300)
    # the reference's x is the same on every shard
    assert all(np.array_equal(rx[0], rx[s]) for s in range(shards))
    x, y, worst = (t.numpy() for t in _model(lp, shards, 300))
    scale = float(np.abs(rx[0]).max())
    assert scale > 0
    np.testing.assert_allclose(x, rx[0], rtol=0, atol=BODY_RTOL * scale)
    np.testing.assert_allclose(y, ry, rtol=0,
                               atol=BODY_RTOL * float(np.abs(ry).max()))
    np.testing.assert_allclose(worst, rworst, rtol=0,
                               atol=BODY_RTOL * float(np.abs(rworst).max()))


@pytest.mark.parametrize("source", ["random", "spine-leaf"])
def test_one_shard_pack_is_the_single_device_pack(source):
    """At one shard the sharded tables, metas and work lists are the
    single-device pack's: what makes the world-1 sharded solve bitwise
    the fused one."""
    if source == "random":
        row, col, val, m, n = _random_coo()
    else:
        lp = _spine_leaf_lp()
        row, col, val, m, n = lp.row, lp.col, lp.val, lp.m, lp.n
    one = ps.ell_pack_sharded(row, col, val, m, n, 1)
    op = ps.ell_pack(row, col, val, m, n)
    for got, want in ((one.row_idx, op.rows.idx), (one.row_val, op.rows.val),
                      (one.col_idx, op.cols.idx), (one.col_val, op.cols.val)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert one.row_meta == op.rows.meta and one.col_meta == op.cols.meta
    for a, b in ((one.row_work[0], op.rows.work),
                 (one.col_work[0], op.cols.work)):
        assert all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in ("lengths", "order", "items"))


def test_lockstep_model_in_kernel_order_tracks_torch_order():
    """order="kernel" (each shard's rows summed as the card's split
    entries sum them) stays within float rounding of order="torch"."""
    lp = _spine_leaf_lp()
    op, vecs, ell = solver._pack_pallas_sharded(*_scaled(lp), 2, CPU)
    z = torch.zeros
    args = (z(op.n_pad), z(op.m_pad), *vecs, z(op.n_pad, dtype=torch.bool),
            z(op.m_pad, dtype=torch.bool), *ell)
    kw = dict(row_meta=op.row_meta, col_meta=op.col_meta, iters=100)
    a = ps.pdhg_update_burst_sharded(*args, **kw)
    b = ps.pdhg_update_burst_sharded(*args, **kw, order="kernel",
                                     **ps.sharded_work(op, CPU))
    scale = float(a[0].abs().max())
    assert float((a[0] - b[0]).abs().max()) <= 1e-4 * scale


def test_sharded_wrapper_checks_operands():
    lp = _spine_leaf_lp()
    op, vecs, ell = solver._pack_pallas_sharded(*_scaled(lp), 2, CPU)
    z = torch.zeros
    base = dict(row_meta=op.row_meta, col_meta=op.col_meta, iters=1)
    c, tau, xmax, q, sig, ub = vecs
    keep_n = z(op.n_pad, dtype=torch.bool)
    keep_m = z(op.m_pad, dtype=torch.bool)
    # two shards' y side with one shard's tables
    size = ps.table_len(op.row_meta)
    with pytest.raises(ValueError, match="row_idx must hold 2 shards"):
        ops.pdhg_burst_sharded(None, c, tau, xmax, q, sig, ub, keep_n,
                               keep_m, ell[0][:size], ell[1], *ell[2:],
                               z(op.n_pad), z(op.m_pad), **base)
    with pytest.raises(ValueError, match="row_work must list"):
        ops.pdhg_burst_sharded(None, c, tau, xmax, q, sig, ub, keep_n,
                               keep_m, *ell, z(op.n_pad), z(op.m_pad),
                               **base, **dict(ps.sharded_work(op, CPU),
                                              row_work=[]))
    # group None: this process holds both shards, the lockstep model
    got = ops.pdhg_burst_sharded(None, c, tau, xmax, q, sig, ub, keep_n,
                                 keep_m, *ell, z(op.n_pad), z(op.m_pad),
                                 **dict(base, iters=30))
    want = _model(lp, 2, 30)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------------ solver_group
def test_solver_group_rejects_nonpositive():
    with pytest.raises(ValueError, match=">= 1"):
        sharding.solver_group(0)


def test_solver_group_without_a_world_names_torchrun():
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 3"):
        sharding.solver_group(3)
    with pytest.raises(ValueError, match="init_process_group"):
        sharding.solver_group(1)


# ------------------------------------------------------------ gloo worlds
@pytest.fixture(scope="module")
def warm_reference():
    """The reference's healthy pallas solve and its warm re-solve of the
    sub-problem (tests/test_torch_warm.py's)."""
    rp, rsub, keep = torch_ranks.warm_problems(REF)
    r = r_solver.solve_fast(rp, "energy", iters=3000, tol=2e-3,
                            backend="pallas")
    want = r_solver.solve_fast_warm(rsub, "energy", warm=r, flow_map=keep,
                                    iters=3000, tol=2e-3, backend="pallas")
    return convert.fast_result_to_arrays(r), want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, warm_reference):
    """worlds(w): world size w's per-rank results, one spawn a size at
    its first use; a world that fails fails only the tests that use it."""
    payload = dict(BATCH, warm=warm_reference[0])
    cache: dict = {}

    def get(w):
        if w not in cache:
            try:
                cache[w] = torch_ranks.run(
                    w, torch_ranks.shard_cases, payload,
                    tmp_path_factory.mktemp(f"world{w}"))
            except Exception as e:   # reported by every test of world w
                cache[w] = e
        if isinstance(cache[w], Exception):
            raise cache[w]
        return cache[w]
    return get


@functools.lru_cache(maxsize=None)
def _reference_fast(name):
    """The reference's single-device pallas solve (interpret mode) of
    tests/test_scale.py's problem."""
    return r_solver.solve_fast(_ref_problem(name), "energy",
                               iters=torch_ranks.ITERS, backend="pallas")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_x_bitwise_on_every_rank_and_repeatable(worlds, world):
    ranks = worlds(world)
    x0, y0, _ = ranks[0]["traj"][0]
    for r, res in enumerate(ranks):
        for x, y, _ in res["traj"]:
            assert np.array_equal(x, x0) and np.array_equal(y, y0), r


@pytest.mark.parametrize("world", [1, 2, 4])
def test_ranks_equal_the_single_process_model(worlds, world):
    lp = _spine_leaf_lp()
    x, y, worst = _model(lp, world, 300)
    got_x, got_y, primal = worlds(world)[0]["traj"][0]
    assert np.array_equal(got_x, x.numpy()[:lp.n].astype(np.float64))
    assert np.array_equal(got_y, y.numpy()[:lp.m].astype(np.float64))
    assert primal == float(worst.max())


def test_world_one_driver_bitwise_the_fused_burst(worlds):
    (fused_x, fused_y, fused_obj), (x, y, obj) = worlds(1)[0]["driver"]
    assert np.array_equal(x, fused_x) and np.array_equal(y, fused_y)
    assert obj == fused_obj


@pytest.mark.parametrize("world", [2])
@pytest.mark.parametrize("topo_name", torch_ranks.PAPER_TOPOS)
def test_sharded_matches_single_device_reference(worlds, world, topo_name):
    ref = _reference_fast(topo_name)
    ranks = worlds(world)
    got = ranks[0][topo_name]
    assert all(res[topo_name] == got for res in ranks)
    assert got["cert_ok"] and got["remaining"] <= 1e-6
    assert got["feasible"] == ref.metrics.feasible
    assert got["energy_j"] == pytest.approx(ref.metrics.energy_j, rel=RTOL)
    assert got["completion_s"] == pytest.approx(ref.metrics.completion_s,
                                                rel=RTOL)


@pytest.mark.parametrize("topo_name", torch_ranks.PAPER_TOPOS)
def test_four_rank_rung_matches_single_device_reference(worlds, topo_name):
    """A fixed rung at 4 ranks within 1e-4 of the reference's
    single-device pallas rung (tests/test_scale.py's LP-level check),
    x the same on every rank."""
    rlp, _ = r_solver.build_routing_lp(_ref_problem(topo_name), "energy")
    want = r_solver._solve_lp_pallas(rlp, torch_ranks.RUNG, 1e-9, 0, None,
                                     None).x
    ranks = worlds(4)
    got = ranks[0][topo_name]
    assert all(np.array_equal(res[topo_name], got) for res in ranks)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= RTOL * scale


@pytest.mark.parametrize("world", [2, 4])
def test_solver_group_refuses_another_world_size(worlds, world):
    msg = worlds(world)[0]["group_error"]
    assert f"needs a world of {world + 1} ranks" in msg
    assert f"has {world}" in msg and "torchrun" in msg


def test_sharded_batch_matches_reference(worlds):
    rprobs = [_ref_problem("pon3", BATCH["batch_pattern"], s)
              for s in BATCH["batch_seeds"]]
    want = r_solver.solve_fast_batch(rprobs, "energy",
                                     iters=BATCH["batch_iters"],
                                     backend="pallas")
    got = worlds(2)[0]["batch"]
    assert got == worlds(2)[1]["batch"]
    for g, w in zip(got, want):
        assert g["cert_ok"] and g["remaining"] <= 1e-6
        assert g["energy_j"] == pytest.approx(w.metrics.energy_j, rel=RTOL)
        assert g["completion_s"] == pytest.approx(w.metrics.completion_s,
                                                  rel=RTOL)


def test_sharded_warm_resolve_matches_reference(worlds, warm_reference):
    want = warm_reference[1]
    got = worlds(2)[0]["warm"]
    assert got == worlds(2)[1]["warm"]
    assert got["warm_started"] and want.warm_started
    assert got["cert_ok"] and got["remaining"] <= 1e-6
    assert got["energy_j"] == pytest.approx(want.metrics.energy_j, rel=RTOL)
    assert got["completion_s"] == pytest.approx(want.metrics.completion_s,
                                                rel=RTOL)


# --------------------------------------------------------- the sweep CLI
SWEEP = ["-m", "repro_torch.sweep", "--device", "cpu", "--backend", "pallas",
         "--topos", "pon3", "--objectives", "energy", "--patterns",
         "uniform", "--seeds", "2", "--total-gbits", "8", "--n-map", "4",
         "--n-reduce", "3", "--iters", "1200", "--oracle-check", "0"]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_sweep_under_torchrun_matches_mesh_one(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    one = subprocess.run([sys.executable, *SWEEP, "--out",
                          str(tmp_path / "one")], capture_output=True,
                         text=True, timeout=300, env=env)
    assert one.returncode == 0, one.stderr[-3000:]
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", *SWEEP, "--mesh", "2", "--out",
         str(tmp_path / "two")], capture_output=True, text=True,
        timeout=300, env=env)
    assert two.returncode == 0, two.stderr[-3000:]
    # rank 0 alone prints the summary line
    assert two.stdout.count("(0 infeasible)") == 1, two.stdout[-3000:]
    a, b = _rows(tmp_path / "one" / "results.csv"), \
        _rows(tmp_path / "two" / "results.csv")
    assert len(a) == len(b) == 2
    for ra, rb in zip(a, b):
        assert rb["feasible"] == "True" and float(rb["max_violation"]) == 0.0
        for col in ("energy_j", "completion_s"):
            assert float(rb[col]) == pytest.approx(float(ra[col]), rel=RTOL)
