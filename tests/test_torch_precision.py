"""bf16 iterate storage in the port: the plain bf16 burst against the
reference's Pallas kernel (interpret mode on the CPU), and the contracts
of tests/test_precision.py on the port's solve_fast(precision="bf16").

The bf16 CUDA entry (pdhg_burst_bf16) cannot run here: chip_smoke.py
holds it against this plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro_torch.core import solver, timeslot, topology, traffic, verify
from repro_torch.kernels import ops, pdhg_spmv

# one bf16 place: 2**-7 of a value (8 significant bits)
BF16_PLACE = 2.0 ** -7
# the fp32 tolerance of tests/test_torch_pdhg.py at one iteration: the
# plain version and the reference differ only in the order of each row's
# sum, which can also move a stored value across a bf16 rounding boundary
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These solves run thousands of tiny torch ops; one intra-op thread
    keeps parallel test workers from oversubscribing the CPU with
    spinning thread pools, which slows such ops by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _burst_inputs(seed, m, n, m_eq, frozen):
    """numpy operands of one burst: a random operator with a few wide
    rows, preconditioners from its row/column sums, frozen masks."""
    rng = np.random.default_rng(seed)
    row = np.concatenate([rng.integers(0, m, 8 * m),
                          np.repeat(rng.integers(0, m, 2), 40)])
    col = rng.integers(0, n, len(row))
    val = rng.normal(size=len(row))
    op = pdhg_spmv.ell_pack(row, col, val, m, n)
    cs = np.zeros(n)
    np.add.at(cs, col, np.abs(val))
    rs = np.zeros(m)
    np.add.at(rs, row, np.abs(val))
    keep_n = np.zeros(op.n_pad, bool)
    keep_m = np.zeros(op.m_pad, bool)
    keep_n[:n] = rng.random(n) < frozen
    keep_m[:m] = rng.random(m) < frozen

    def padn(a):
        return np.pad(np.asarray(a, np.float32), (0, op.n_pad - n))

    def padm(a):
        return np.pad(np.asarray(a, np.float32), (0, op.m_pad - m))

    args = (padn(rng.normal(size=n)), padn(1.0 / np.maximum(cs, 1e-12)),
            padn(rng.uniform(0.5, 4.0, n)), padm(rng.normal(size=m)),
            padm(1.0 / np.maximum(rs, 1e-12)),
            np.pad(np.arange(m) >= m_eq, (0, op.m_pad - m),
                   constant_values=True),
            keep_n, keep_m, op.rows.idx, op.rows.val, op.cols.idx,
            op.cols.val, padn(rng.uniform(0.0, 1.0, n)),
            padm(rng.normal(size=m)))
    return op, args


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("m,n,m_eq,frozen", [(41, 33, 20, 0.3),
                                             (200, 150, 90, 0.2)])
def test_plain_bf16_burst_matches_reference(m, n, m_eq, frozen, iters):
    op, args = _burst_inputs(m + n, m, n, m_eq, frozen)
    kw = dict(row_meta=op.rows.meta, col_meta=op.cols.meta, iters=iters)
    got = ops.pdhg_burst(*(torch.from_numpy(a) for a in args), **kw,
                         precision="bf16")
    want = r_ops.pdhg_burst(*(jnp.asarray(a) for a in args), **kw,
                            interpret=True, precision="bf16")
    for name, g, w in zip(("x", "y", "worst"), got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == np.float32
        np.testing.assert_array_less(
            np.abs(g - w), ATOL + (RTOL + BF16_PLACE) * np.abs(w) + 1e-30,
            err_msg=name)
    x, y = got[0].numpy(), got[1].numpy()
    # the stored iterates are bf16 values, widened
    assert np.array_equal(x, _bf16(x)) and np.array_equal(y, _bf16(y))
    # frozen coordinates hold their rounded start, padding stays at zero
    x0, y0, keep_n, keep_m = args[12], args[13], args[6], args[7]
    assert np.array_equal(x[keep_n], _bf16(x0)[keep_n])
    assert np.array_equal(y[keep_m], _bf16(y0)[keep_m])
    assert np.all(x[n:] == 0.0) and np.all(y[m:] == 0.0)


def test_bf16_burst_of_zero_iterations_rounds_the_start():
    op, args = _burst_inputs(5, 41, 33, 20, 0.0)
    kw = dict(row_meta=op.rows.meta, col_meta=op.cols.meta, iters=0)
    x, y, _ = ops.pdhg_burst(*(torch.from_numpy(a) for a in args), **kw,
                             precision="bf16")
    assert np.array_equal(x.numpy(), _bf16(args[12]))
    assert np.array_equal(y.numpy(), _bf16(args[13]))
    assert not np.array_equal(x.numpy(), args[12])   # rounding happened
    rx, ry, _ = r_ops.pdhg_burst(*(jnp.asarray(a) for a in args), **kw,
                                 interpret=True, precision="bf16")
    assert np.array_equal(x.numpy(), np.asarray(rx))
    assert np.array_equal(y.numpy(), np.asarray(ry))


def test_unknown_precision_rejected():
    op, args = _burst_inputs(5, 9, 6, 4, 0.0)
    with pytest.raises(ValueError, match="precision"):
        ops.pdhg_burst(*(torch.from_numpy(a) for a in args),
                       row_meta=op.rows.meta, col_meta=op.cols.meta,
                       iters=1, precision="fp16")


# -- the contracts of tests/test_precision.py, on the port ------------------

def _problem(topo_name: str, seed: int = 0):
    topo = topology.build(topo_name)
    pat = traffic.pattern("uniform", n_map=4, n_reduce=3)
    cf = traffic.generate(topo, pat, seed=seed)
    return timeslot.ScheduleProblem(
        topo, cf, n_slots=timeslot.suggest_n_slots(topo, cf))


@pytest.mark.parametrize("topo_name", ["spine-leaf", "pon3"])
def test_bf16_certifies_with_metrics_within_1e3_of_fp32(topo_name):
    p = _problem(topo_name)
    f32 = solver.solve_fast(p, "energy", iters=1500,
                            backend="pallas", device="cpu")
    b16 = solver.solve_fast(p, "energy", iters=1500, precision="bf16",
                            backend="pallas", device="cpu")
    # check_schedule's default tolerances are the fp32 ones
    cert = verify.check_schedule(p, b16.schedule)
    assert cert.ok, cert
    assert b16.metrics.feasible and b16.metrics.max_violation == 0.0
    assert b16.metrics.energy_j == pytest.approx(f32.metrics.energy_j,
                                                 rel=1e-3)
    assert b16.metrics.completion_s == pytest.approx(
        f32.metrics.completion_s, rel=1e-3)
    np.testing.assert_allclose(b16.metrics.served, f32.metrics.served,
                               rtol=1e-3)


@pytest.mark.parametrize("topo_name", ["spine-leaf", "pon3"])
def test_bf16_time_objective_completion_within_125(topo_name):
    p = _problem(topo_name)
    f32 = solver.solve_fast(p, "time", iters=1500,
                            backend="pallas", device="cpu")
    b16 = solver.solve_fast(p, "time", iters=1500, precision="bf16",
                            backend="pallas", device="cpu")
    assert verify.check_schedule(p, b16.schedule).ok
    assert b16.metrics.feasible
    assert b16.metrics.completion_s <= f32.metrics.completion_s * 1.25


def test_bf16_lp_iterates_stay_finite_boxed_and_on_the_bf16_grid():
    p = _problem("spine-leaf")
    lp, _ = solver.build_routing_lp(p, "energy")
    r = solver.solve_lp(lp, iters=400, precision="bf16",
                        backend="pallas", device="cpu")
    assert np.isfinite(r.x).all()
    xmax = np.where(np.isfinite(lp.xmax), lp.xmax, np.inf)
    # bf16 storage rounds within the box, never outside it by more than
    # one ulp of the bound
    assert (r.x >= -1e-6).all()
    assert (r.x <= xmax * (1 + 2 ** -8) + 1e-6).all()
    x32 = r.x.astype(np.float32)
    assert np.array_equal(x32, _bf16(x32))
