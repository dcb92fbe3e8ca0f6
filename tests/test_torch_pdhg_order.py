"""The CUDA burst kernel's summation order, modelled on the CPU.

kernels/csrc/pdhg_burst.cu sums each stored row with L lanes of a warp
(lane l adds slots l, l + L, ... in ascending order, then the L partials
meet in a fixed xor butterfly), L chosen from the row's length, its entry
count in the sparsity pattern.
`pdhg_spmv.spmv_in_kernel_order` is that order in plain torch; the card
holds the kernel to it bitwise (chip_smoke.py phases 3 and 11).  Here it
is held to spmv_blocks within fp32 tolerance, to a numpy float32
emulation of the lanes and the tree bit for bit, and shown to differ
from the sequential order where it should.  The kernel's work list
(`work_list`, with `lane_count`) must take every row once at its L, be
built once per pattern and be refused by the wrapper when malformed, and
a member of a block-stacked operator must sum its rows as it does alone.
Inputs come from numpy seeds.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, pdhg_spmv

F32 = np.float32


def _random_op(seed, m, n, spread=3.0):
    """A random operator with three rows of 150 extra entries; values
    normal times 10^U(-spread, spread)."""
    rng = np.random.default_rng(seed)
    row = np.concatenate([rng.integers(0, m, 8 * m),
                          np.repeat(rng.integers(0, m, 3), 150),
                          np.arange(m)])
    col = rng.integers(0, n, len(row))
    val = (rng.normal(size=len(row))
           * 10.0 ** rng.uniform(-spread, spread, len(row)))
    return pdhg_spmv.ell_pack(row, col, val, m, n), rng


def _sums(blocks, vec, order):
    idx, val = torch.from_numpy(blocks.idx), torch.from_numpy(blocks.val)
    vec = torch.from_numpy(np.asarray(vec, F32))
    if order == "kernel":
        plan = pdhg_spmv.lane_plan(blocks.meta, blocks.work.lengths, "cpu")
        return pdhg_spmv.spmv_in_kernel_order(vec, idx, val, plan).numpy()
    g = pdhg_spmv.width_groups(blocks.meta, "cpu")
    return pdhg_spmv.spmv_blocks(vec, idx[g.perm], val[g.perm], g).numpy()


def _emulate(blocks, vec) -> np.ndarray:
    """The kernel's sums, one lane and one butterfly step at a time, in
    numpy float32: lane l of L (from the row's length) adds slots l,
    l + L, ... below the row's length from +0.0 (product rounded, then
    the sum); then p[i] += p[i + L/2], ..., down to one partial."""
    vec = np.asarray(vec, F32)
    start = pdhg_spmv.row_starts(blocks.meta)
    length = blocks.work.lengths
    out = np.zeros(len(start), F32)
    for r in range(len(start)):
        L = int(pdhg_spmv.lane_count(length[r]))
        parts = []
        for lane in range(L):
            s = F32(0.0)
            for j in range(lane, length[r], L):
                k = start[r] + j
                s = F32(s + F32(blocks.val[k] * vec[blocks.idx[k]]))
            parts.append(s)
        while len(parts) > 1:
            half = len(parts) // 2
            parts = [F32(parts[i] + parts[i + half]) for i in range(half)]
        out[r] = parts[0]
    return out


def _block_widths(meta) -> np.ndarray:
    """The padded width of every stored row's block."""
    _, widths, bm, _ = meta
    return np.repeat(np.asarray(widths, np.int64), bm)


def _sequential(blocks, vec) -> np.ndarray:
    """Each row summed slot after slot over its block's width."""
    vec = np.asarray(vec, F32)
    start = pdhg_spmv.row_starts(blocks.meta)
    width = _block_widths(blocks.meta)
    out = np.zeros(len(start), F32)
    for r in range(len(start)):
        s = F32(0.0)
        for k in range(start[r], start[r] + width[r]):
            s = F32(s + F32(blocks.val[k] * vec[blocks.idx[k]]))
        out[r] = s
    return out


# rows of width 8, 64 and 472 (8 rows each, one block each), every slot
# filled, built so that the order matters: vec is all ones and row r's
# slots read 2^24, then terms of 1 / (1 + r % 8), then -2^24, so the terms
# added next to 2^24 are rounded away (2^24 + 1 is a tie that rounds back
# to 2^24) and those a lane adds apart from it are kept
WIDTHS = (8, 64, 472)


def _ordered_rows():
    rows, cols, vals = [], [], []
    for b, w in enumerate(WIDTHS):
        for r in range(8 * b, 8 * b + 8):
            v = np.ones(w)
            v[0], v[-1] = 2.0 ** 24, -(2.0 ** 24)
            v[1:-1] /= 1.0 + (r % 8)       # 1, 1/2, ..., 1/8
            rows.append(np.full(w, r))
            cols.append(np.arange(w) % 500)
            vals.append(v)
    m = 8 * len(WIDTHS)
    op = pdhg_spmv.ell_pack(np.concatenate(rows), np.concatenate(cols),
                            np.concatenate(vals), m, 500)
    assert op.rows.widths == WIDTHS
    return op.rows, np.ones(op.n_pad, F32)


def test_lane_count_rule():
    w = np.arange(0, 2000)
    want = np.minimum(32, 2 ** np.floor(np.log2(np.maximum(1, w // 8))))
    assert np.array_equal(pdhg_spmv.lane_count(w), want)
    assert [pdhg_spmv.lane_count(x) for x in WIDTHS] == [1, 8, 32]
    assert torch.equal(pdhg_spmv.lane_count(torch.from_numpy(w)),
                       torch.from_numpy(want.astype(np.int64)))


def test_rows_end_at_their_last_nonzero_slot():
    """A row's length is its entry count, which (with no explicit zero
    among the values) is its last nonzero slot + 1, short of its block's
    width in some rows; a value set to zero later leaves the lengths as
    they are."""
    rng = np.random.default_rng(3)
    row = np.concatenate([rng.integers(0, 60, 480), np.arange(60)])
    col = rng.integers(0, 40, len(row))
    val = rng.normal(size=len(row))
    plan = pdhg_spmv.ell_plan(row, col, 60, 40)
    op = pdhg_spmv.ell_fill(plan, val)
    length = op.rows.work.lengths
    start = pdhg_spmv.row_starts(op.rows.meta)
    width = _block_widths(op.rows.meta)
    counts = np.bincount(row, minlength=op.m_pad)
    assert length.dtype == np.int32 and np.array_equal(length, counts)
    for r in range(len(start)):
        nz = np.flatnonzero(op.rows.val[start[r]:start[r] + width[r]])
        assert length[r] == (nz[-1] + 1 if len(nz) else 0)
    assert np.any(length[:op.m] < width[:op.m])
    assert np.all(length[op.m:] == 0)
    zeroed = val.copy()
    zeroed[row == 0] = 0.0        # row 0's values all become zeros
    again = pdhg_spmv.ell_fill(plan, zeroed)
    assert not again.rows.val[:width[0]].any() and length[0] > 0
    assert again.rows.work is op.rows.work


@pytest.mark.parametrize("seed,m,n", [(0, 50, 40), (1, 300, 250),
                                      (2, 9, 6)])
def test_kernel_order_matches_spmv_blocks(seed, m, n):
    op, rng = _random_op(seed, m, n)
    for blocks, size in ((op.rows, op.n_pad), (op.cols, op.m_pad)):
        vec = rng.normal(size=size).astype(F32)
        want = _sums(blocks, vec, "torch")
        got = _sums(blocks, vec, "kernel")
        scale = (np.abs(blocks.val.reshape(1, -1)).max()
                 * np.abs(vec).max())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("build", ["ordered", "random"])
def test_kernel_order_equals_numpy_emulation_bitwise(build):
    if build == "ordered":
        blocks, vec = _ordered_rows()
    else:
        op, rng = _random_op(4, 120, 90)
        blocks, vec = op.rows, rng.normal(size=op.n_pad).astype(F32)
        assert len(set(pdhg_spmv.lane_count(blocks.work.lengths))) > 1
    got = _sums(blocks, vec, "kernel")
    np.testing.assert_array_equal(got.view(np.int32),
                                  _emulate(blocks, vec).view(np.int32))


def test_kernel_order_differs_from_sequential_where_lanes_split():
    blocks, vec = _ordered_rows()
    got = _sums(blocks, vec, "kernel")
    seq = _sequential(blocks, vec)
    for b, w in enumerate(WIDTHS):
        rows = slice(8 * b, 8 * b + 8)
        if pdhg_spmv.lane_count(w) == 1:
            # one lane: the lane split is the sequential order
            np.testing.assert_array_equal(got[rows], seq[rows])
        else:
            assert np.all(got[rows] != seq[rows]), (w, got[rows], seq[rows])
    # sequentially every small term next to 2^24 is rounded away
    assert np.all(seq == 0.0)


def test_work_list_takes_every_row_once_at_its_lane_count():
    op, _ = _random_op(5, 400, 300)
    for blocks in (op.rows, op.cols):
        lanes = pdhg_spmv.lane_count(blocks.work.lengths.astype(np.int64))
        order, items = blocks.work.order, blocks.work.items
        assert order.dtype == np.int32 and items.dtype == np.int32
        seen = np.zeros(len(lanes), int)
        for first, packed in items:
            shift, n_rows = packed & 0xFF, packed >> 8
            rows = order[first:first + n_rows]
            assert 1 <= n_rows <= 32 >> shift
            assert np.all(lanes[rows] == 1 << shift)
            seen[rows] += 1
        assert np.all(seen == 1)
        # no more tasks than each lane count needs
        need = sum(-(-int(np.sum(lanes == L)) // (32 // L))
                   for L in np.unique(lanes))
        assert len(items) == need


def test_a_stacked_member_sums_its_rows_as_alone():
    """Stack two operators with the second's rows and columns shifted by
    a count that is no multiple of the block size, so blocks straddle the
    two: member 0's sums in kernel order stay bitwise its own."""
    rng = np.random.default_rng(6)
    parts = []
    # member 1's wide rows come first, so the block member 0's last rows
    # share with them is wider than it is alone
    for m, n, wide in ((37, 29, [3, 17]), (45, 33, [0, 1])):
        row = np.concatenate([rng.integers(0, m, 6 * m),
                              np.repeat(wide, 90), np.arange(m)])
        col = rng.integers(0, n, len(row))
        parts.append((row, col, rng.normal(size=len(row)), m, n))
    (r0, c0, v0, m0, n0), (r1, c1, v1, m1, n1) = parts
    alone = pdhg_spmv.ell_pack(r0, c0, v0, m0, n0)
    stacked = pdhg_spmv.ell_pack(np.r_[r0, r1 + m0], np.r_[c0, c1 + n0],
                                 np.r_[v0, v1], m0 + m1, n0 + n1)
    x = rng.normal(size=stacked.n_pad).astype(F32)
    y = rng.normal(size=stacked.m_pad).astype(F32)
    x_alone = np.pad(x[:n0], (0, alone.n_pad - n0))
    y_alone = np.pad(y[:m0], (0, alone.m_pad - m0))
    # a lane count chosen by block width would differ for some row
    by_block = [pdhg_spmv.lane_count(_block_widths(b.meta)[:k])
                for b, k in ((stacked.rows, m0), (alone.rows, m0),
                             (stacked.cols, n0), (alone.cols, n0))]
    assert (np.any(by_block[0] != by_block[1])
            or np.any(by_block[2] != by_block[3]))
    for got, want, k in ((_sums(stacked.rows, x, "kernel"),
                          _sums(alone.rows, x_alone, "kernel"), m0),
                         (_sums(stacked.cols, y, "kernel"),
                          _sums(alone.cols, y_alone, "kernel"), n0)):
        np.testing.assert_array_equal(got[:k].view(np.int32),
                                      want[:k].view(np.int32))


def _burst(seed, m, n, m_eq):
    op, rng = _random_op(seed, m, n, spread=0.0)
    t = torch.from_numpy
    keep_n = np.zeros(op.n_pad, bool)
    keep_n[:n] = rng.random(n) < 0.2
    keep_m = np.zeros(op.m_pad, bool)
    keep_m[:m] = rng.random(m) < 0.2
    cs = np.abs(op.cols.val).reshape(-1)
    tau = np.full(op.n_pad, 1.0 / max(float(cs.sum()) / n, 1e-12), F32)
    sig = np.full(op.m_pad, 1.0 / max(float(cs.sum()) / m, 1e-12), F32)
    tau[n:], sig[m:] = 0.0, 0.0
    args = (np.pad(rng.normal(size=n), (0, op.n_pad - n)).astype(F32), tau,
            np.pad(rng.uniform(0.5, 4.0, n), (0, op.n_pad - n)).astype(F32),
            np.pad(rng.normal(size=m), (0, op.m_pad - m)).astype(F32), sig,
            np.pad(np.arange(m) >= m_eq, (0, op.m_pad - m),
                   constant_values=True), keep_n, keep_m,
            op.rows.idx, op.rows.val, op.cols.idx, op.cols.val,
            np.pad(rng.uniform(0, 1, n), (0, op.n_pad - n)).astype(F32),
            np.pad(rng.normal(size=m), (0, op.m_pad - m)).astype(F32))
    return op, tuple(t(np.ascontiguousarray(a)) for a in args)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("iters", [0, 1, 30])
def test_burst_in_kernel_order_close_to_torch_order(iters, precision):
    op, a = _burst(7, 80, 60, 30)
    kw = dict(row_meta=op.rows.meta, col_meta=op.cols.meta, iters=iters,
              precision=precision, **pdhg_spmv.burst_work(op, "cpu"))
    want = pdhg_spmv.pdhg_update_burst(a[12], a[13], *a[:12], **kw)
    got = pdhg_spmv.pdhg_update_burst(a[12], a[13], *a[:12], **kw,
                                      order="kernel")
    x_scale = float(want[0].abs().max())
    if iters == 0:
        # no sum reaches x or y
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got, want):
        tol = 1e-5 if precision == "fp32" else 2.0 ** -7
        torch.testing.assert_close(g, w, rtol=tol,
                                   atol=1e-4 * max(x_scale, 1.0))
    assert torch.equal(got[0][op.n:], torch.zeros(op.n_pad - op.n))
    with pytest.raises(ValueError, match="order"):
        pdhg_spmv.pdhg_update_burst(a[12], a[13], *a[:12], **kw,
                                    order="sequential")


def test_work_list_is_built_once_per_pattern():
    """The plan carries the work list: a refill with other values (zeros
    included) shares it, and burst_work puts it on a device as the
    int32 tensors the wrapper checks."""
    rng = np.random.default_rng(8)
    row = np.concatenate([rng.integers(0, 40, 320), np.arange(40)])
    col = rng.integers(0, 30, len(row))
    plan = pdhg_spmv.ell_plan(row, col, 40, 30)
    op = pdhg_spmv.ell_fill(plan, rng.normal(size=len(row)))
    other = pdhg_spmv.ell_fill(plan, np.zeros(len(row)))
    assert other.rows.work is op.rows.work is plan.rows.work
    assert other.cols.work is op.cols.work is plan.cols.work
    work = pdhg_spmv.burst_work(op, "cpu")
    for name, meta, blocks in (("row_work", op.rows.meta, op.rows),
                               ("col_work", op.cols.meta, op.cols)):
        length, order, items = work[name]
        ops._check_work(name, work[name], meta, torch.device("cpu"))
        assert torch.equal(length, torch.from_numpy(blocks.work.lengths))
        assert sorted(order.tolist()) == list(range(meta[3]))
        assert items.shape == (len(blocks.work.items), 2)


def test_wrapper_refuses_a_malformed_work_list():
    """ops.pdhg_burst checks a work list wherever it is given (on the card
    it is required): the wrong count of tensors, dtype, length or rank,
    or the other direction's list, raises before any burst runs."""
    op, a = _burst(9, 40, 30, 20)
    work = pdhg_spmv.burst_work(op, "cpu")
    length, order, items = work["row_work"]
    kw = dict(row_meta=op.rows.meta, col_meta=op.cols.meta, iters=1)
    good = ops.pdhg_burst(*a, **kw, **work)
    assert all(torch.equal(g, w) for g, w in
               zip(good, ops.pdhg_burst(*a, **kw)))
    for bad in ([length, order, items], (length, order),
                (length.long(), order, items), (length[:-1], order, items),
                (length, order, items[:, 0])):
        with pytest.raises(ValueError, match="row_work"):
            ops.pdhg_burst(*a, **kw, row_work=bad,
                           col_work=work["col_work"])
    with pytest.raises(ValueError, match="col_work"):
        ops.pdhg_burst(*a, **kw, row_work=work["row_work"],
                       col_work=work["row_work"])
