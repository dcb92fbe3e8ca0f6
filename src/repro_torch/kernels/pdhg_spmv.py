"""Blocked-ELL layout and the plain PyTorch PDHG burst.

The routing-LP hot loop (core.solver) spends essentially all of its time
in two sparse mat-vecs per iteration — K.x and K^T.y — plus elementwise
prox/clip updates.  The operator is packed into a padded **blocked-ELL**
layout (gather-friendly, no scatters at all) in both directions, and a
whole `iters`-iteration PDHG burst runs over it: K^T.y gather, primal
prox/clip against xmax, K.x, dual ascent + inequality projection, and
the terminal residual vector.

This module holds the parts that are not the CUDA kernel:

  * the layout (`ell_blocks_plan` ... `ell_pack`): a numpy copy of the
    reference `repro.kernels.pdhg_spmv` layout, kept bitwise equal to it
    (tests/test_torch_lp.py);
  * the plain version of the burst (`spmv_blocks`, `pdhg_update_burst`)
    in torch, fp32 or bf16 iterate storage, with the reference's formulas
    and freeze masks.  The CPU tests run it, and the card compares the
    hand kernel (kernels/csrc/pdhg_burst.cu, wrapped by
    kernels.ops.pdhg_burst) against it;
  * the kernel's summation order: which lanes sum which slots of a row
    (`lane_count`), the warps' work list built from it once per sparsity
    pattern (`work_list`, carried by every EllBlocks; `burst_work` puts
    it on a device), and the same sums in plain torch
    (`spmv_in_kernel_order`, `pdhg_update_burst(order="kernel")`), which
    the kernel equals bitwise.  Nothing on the main path calls the
    latter; chip_smoke.py holds the kernel to it;
  * the row-sharded form (`ell_pack_sharded`, `pdhg_update_burst_sharded`):
    the reference's S-way row-block partition, bitwise its layout, and
    the plain body of a sharded burst, whose one collective an
    iteration (the sum of the shards' partials of K^T.y) the caller
    passes in; kernels.ops.ShardedBurst runs it across ranks, on the
    card through the burst kernel's split step.

Blocked-ELL layout
------------------
Rows keep their original order (no permutation — PDHG vectors stay in LP
index space) and are grouped into blocks of `bm` consecutive rows; each
block is padded to its own width (the block's max row degree, rounded up
to a multiple of `align`) and stored row-major in one flat (idx, val)
pair.  Padding entries carry idx=0, val=0 so they gather slot 0 and
contribute nothing.  The transpose direction (K^T for the primal update)
is the same layout built from the column index.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class WorkList:
    """The CUDA kernel's work list of one direction, a function of the
    sparsity pattern alone (see `work_list`)."""

    lengths: np.ndarray        # (n_rows_pad,) int32 entries of each row
    order: np.ndarray          # (n_rows_pad,) int32 rows sorted by L
    items: np.ndarray          # (n_items, 2) int32 warp tasks


@dataclasses.dataclass(frozen=True)
class EllBlocks:
    """One SpMV direction in blocked-ELL: per stored row, a padded gather.

    Block b holds rows [b*bm, (b+1)*bm) in row-major order at
    idx/val[offsets[b] : offsets[b] + bm*widths[b]]; `n_rows` true rows,
    padded up to `n_rows_pad = n_blocks * bm` with empty rows."""

    idx: np.ndarray            # (total,) int32 gather indices, 0 for padding
    val: np.ndarray            # (total,) float coefficients, 0 for padding
    offsets: tuple[int, ...]   # (n_blocks,) flat start of each block
    widths: tuple[int, ...]    # (n_blocks,) padded width of each block
    bm: int                    # rows per block
    n_rows: int                # true row count
    n_rows_pad: int            # n_blocks * bm
    work: WorkList             # the kernel's work list

    @property
    def meta(self) -> tuple:
        """Hashable static description of the layout."""
        return (self.offsets, self.widths, self.bm, self.n_rows_pad)

    @property
    def fill(self) -> float:
        """Fraction of stored slots that carry a real entry."""
        return float(np.count_nonzero(self.val)) / max(len(self.val), 1)


@dataclasses.dataclass(frozen=True)
class EllPlanSide:
    """The value-independent half of one blocked-ELL direction: gather
    indices and storage layout, plus the (order, flat) permutation that
    scatters COO values into storage slots.  Built once per sparsity
    pattern; `ell_refill` turns it into an EllBlocks for any coefficient
    vector in O(nnz) (core.solver caches plans across re-solves)."""

    idx: np.ndarray            # (total,) int32 gather indices, 0 for padding
    order: np.ndarray          # (nnz,) stable row-sort permutation of COO
    flat: np.ndarray           # (nnz,) storage slot of each sorted entry
    size: int                  # total storage slots
    offsets: tuple[int, ...]
    widths: tuple[int, ...]
    bm: int
    n_rows: int
    n_rows_pad: int
    work: WorkList


def ell_blocks_plan(row: np.ndarray, col: np.ndarray, n_rows: int, *,
                    bm: int = 8, align: int = 8,
                    min_widths: np.ndarray | None = None) -> EllPlanSide:
    """Lay out COO entries (keyed by `row`) in blocked-ELL storage.

    Entries keep their COO appearance order within each row (stable
    sort), so repeated packs of the same operator are bit-identical.
    `bm` rows per block; each block's width is its max row degree rounded
    up to a multiple of `align` (>= align even for all-empty blocks).
    `min_widths` (one entry per block, already align-rounded) forces each
    block at least that wide; extra slots are plain padding."""
    assert bm >= 1 and align >= 1
    row = np.asarray(row, np.int64)
    nnz = len(row)
    order = np.argsort(row, kind="stable")
    counts = np.bincount(row, minlength=max(n_rows, 1))
    starts = np.concatenate([[0], np.cumsum(counts)])
    # position of each entry within its row
    pos = np.arange(nnz, dtype=np.int64) - starts[row[order]]

    n_blocks = max(-(-n_rows // bm), 1)
    # per-block width: max row degree in the block, align-rounded (>= align)
    cpad = np.zeros(n_blocks * bm, np.int64)
    lim = min(len(counts), n_blocks * bm)
    cpad[:lim] = counts[:lim]
    w = cpad.reshape(n_blocks, bm).max(axis=1)
    w = np.maximum(-(-w // align) * align, align)
    if min_widths is not None:
        assert len(min_widths) == n_blocks, (len(min_widths), n_blocks)
        w = np.maximum(w, np.asarray(min_widths, np.int64))
    widths_arr = w
    offsets_arr = np.concatenate([[0], np.cumsum(bm * w)[:-1]])
    off = int(np.sum(bm * w))

    r = row[order]
    blk = r // bm
    flat = offsets_arr[blk] + (r - blk * bm) * widths_arr[blk] + pos
    idx = np.zeros(off, np.int32)
    idx[flat] = np.asarray(col, np.int64)[order].astype(np.int32)
    return EllPlanSide(idx=idx, order=order, flat=flat, size=off,
                       offsets=tuple(int(o) for o in offsets_arr),
                       widths=tuple(int(x) for x in widths_arr),
                       bm=bm, n_rows=n_rows, n_rows_pad=n_blocks * bm,
                       work=work_list(cpad))


def ell_refill(plan: EllPlanSide, val: np.ndarray) -> EllBlocks:
    """Scatter a coefficient vector into a plan's storage layout —
    the O(nnz) value-refresh half of `ell_blocks`."""
    vals = np.zeros(plan.size, np.float32)
    vals[plan.flat] = np.asarray(val)[plan.order].astype(np.float32)
    return EllBlocks(idx=plan.idx, val=vals, offsets=plan.offsets,
                     widths=plan.widths, bm=plan.bm, n_rows=plan.n_rows,
                     n_rows_pad=plan.n_rows_pad, work=plan.work)


def ell_blocks(row: np.ndarray, col: np.ndarray, val: np.ndarray,
               n_rows: int, *, bm: int = 8, align: int = 8) -> EllBlocks:
    """Pack COO entries into blocked-ELL rows keyed by `row` (plan +
    refill in one step; see ell_blocks_plan for the layout rules)."""
    return ell_refill(ell_blocks_plan(row, col, n_rows, bm=bm, align=align),
                      val)


@dataclasses.dataclass(frozen=True)
class EllOperator:
    """K (m x n) packed both ways: `rows` gathers x to produce K.x (one
    stored row per constraint), `cols` gathers y to produce K^T.y (one
    stored row per variable)."""

    rows: EllBlocks
    cols: EllBlocks
    m: int
    n: int

    @property
    def m_pad(self) -> int:
        return self.rows.n_rows_pad

    @property
    def n_pad(self) -> int:
        return self.cols.n_rows_pad


@dataclasses.dataclass(frozen=True)
class EllPlan:
    """Both directions of an operator's blocked-ELL layout, values
    excluded — the cacheable product of a COO sparsity pattern."""

    rows: EllPlanSide
    cols: EllPlanSide
    m: int
    n: int


def ell_plan(row: np.ndarray, col: np.ndarray, m: int, n: int, *,
             bm: int = 8, align: int = 8) -> EllPlan:
    """Lay out a COO pattern in both blocked-ELL directions."""
    return EllPlan(rows=ell_blocks_plan(row, col, m, bm=bm, align=align),
                   cols=ell_blocks_plan(col, row, n, bm=bm, align=align),
                   m=m, n=n)


def ell_fill(plan: EllPlan, val: np.ndarray) -> EllOperator:
    """Refresh both directions of a planned operator with new values."""
    return EllOperator(rows=ell_refill(plan.rows, val),
                       cols=ell_refill(plan.cols, val),
                       m=plan.m, n=plan.n)


def ell_pack(row: np.ndarray, col: np.ndarray, val: np.ndarray,
             m: int, n: int, *, bm: int = 8, align: int = 8) -> EllOperator:
    """Pack a COO operator into both blocked-ELL directions."""
    return ell_fill(ell_plan(row, col, m, n, bm=bm, align=align), val)


# ---------------------------------------------------------------------------
# Plain PyTorch version of the burst
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WidthGroups:
    """Index plan for `spmv_blocks`: the storage slots reordered so that
    the rows of each distinct block width are contiguous.  `perm` maps
    grouped position -> storage slot; group g covers [starts[g],
    starts[g+1]) of the grouped order and reshapes to (rows, widths[g]);
    `unperm` maps each row to its position in the concatenated group
    sums.  The number of torch ops per SpMV is then the number of
    distinct widths plus four, not the number of blocks."""

    perm: torch.Tensor
    unperm: torch.Tensor
    widths: tuple[int, ...]
    starts: tuple[int, ...]


def width_groups(meta: tuple, device) -> WidthGroups:
    """Build the WidthGroups of one direction's layout meta."""
    offsets, widths, bm, n_rows_pad = meta
    off = np.asarray(offsets, np.int64)
    wid = np.asarray(widths, np.int64)
    perm, rows, ws, starts = [], [], [], [0]
    for w in np.unique(wid):
        blocks = np.flatnonzero(wid == w)
        perm.append((off[blocks][:, None]
                     + np.arange(bm * w)[None, :]).ravel())
        rows.append((blocks[:, None] * bm + np.arange(bm)[None, :]).ravel())
        ws.append(int(w))
        starts.append(starts[-1] + len(perm[-1]))
    rows = np.concatenate(rows)
    unperm = np.empty(n_rows_pad, np.int64)
    unperm[rows] = np.arange(n_rows_pad)
    return WidthGroups(perm=torch.as_tensor(np.concatenate(perm),
                                            device=device),
                       unperm=torch.as_tensor(unperm, device=device),
                       widths=tuple(ws), starts=tuple(starts))


def spmv_blocks(vec, idx_g, val_g, groups: WidthGroups):
    """Blocked-ELL SpMV: out[r] = sum_j val[r, j] * vec[idx[r, j]], each
    row's gather scaled and summed over its block's padded width — the
    reference's `spmv_blocks` per row.  `idx_g`/`val_g` are the tables
    in grouped order (`table[groups.perm]`)."""
    g = vec[idx_g] * val_g
    sums = [g[a:b].view(-1, w).sum(dim=1)
            for w, a, b in zip(groups.widths, groups.starts,
                               groups.starts[1:])]
    return torch.cat(sums)[groups.unperm]


# ---------------------------------------------------------------------------
# The CUDA kernel's summation order
# ---------------------------------------------------------------------------
#
# The kernel sums each stored row with L lanes of one warp, L a function
# of the row's length alone (its entry count in the sparsity pattern; the
# entries fill the row's first slots): `lane_count`.  Lane l adds the
# slots j = l, l + L, l + 2L, ... below the length in ascending order,
# from +0.0, each product rounded before it is added; the L partial sums
# then combine in a fixed butterfly, offsets L/2, L/4, ..., 1, which
# lane 0 reads as p = p[:L/2] + p[L/2:] repeated.  The order depends on
# the pattern alone: not on the values, the grid, the scheduling, or the
# block the row shares with its neighbours, so a member of a
# block-stacked batch sums each row as it does alone.

LANE_SLOTS = 8       # a row of length n gets L <= n / 8 lanes
MAX_LANES = 32       # one warp


def lane_count(length):
    """L(n) = min(32, the largest power of two <= max(1, n // 8)): the
    lanes that sum a row of n entries (an int, a numpy array or a torch
    tensor of ints)."""
    k = length // LANE_SLOTS
    return (1 + (k >= 2) * 1 + (k >= 4) * 2 + (k >= 8) * 4 + (k >= 16) * 8
            + (k >= 32) * 16)


def row_starts(meta: tuple) -> np.ndarray:
    """The flat start (int64) of every stored row of a layout."""
    offsets, widths, bm, _ = meta
    w = np.repeat(np.asarray(widths, np.int64), bm)
    return (np.repeat(np.asarray(offsets, np.int64), bm)
            + np.tile(np.arange(bm, dtype=np.int64), len(widths)) * w)


def work_list(lengths: np.ndarray) -> WorkList:
    """The kernel's work list of one direction from each stored row's
    length (its entry count), built once per sparsity pattern by
    `ell_blocks_plan`.  `order` lists the rows by L, ascending rows
    within each L; `items` cuts it into warp tasks of at most 32 / L rows
    of one L: [position of the task's first row in `order`,
    log2(L) | rows << 8].  One warp takes one task at a time."""
    lengths = np.asarray(lengths, np.int64)
    lanes = lane_count(lengths)
    order = np.argsort(lanes, kind="stable")
    sorted_l = lanes[order]
    pos = np.arange(len(order))
    first = np.searchsorted(sorted_l, sorted_l)   # start of each L's run
    heads = np.flatnonzero((pos - first) % (MAX_LANES // sorted_l) == 0)
    rows = np.diff(np.r_[heads, len(order)])
    shift = np.log2(sorted_l[heads]).astype(np.int64)
    items = np.stack([heads, shift | (rows << 8)], axis=1)
    return WorkList(lengths=lengths.astype(np.int32),
                    order=order.astype(np.int32),
                    items=items.astype(np.int32))


def burst_work(op: EllOperator, device) -> dict:
    """The burst's `row_work` / `col_work` keywords for `op`: each
    direction's (lengths, order, items) as int32 tensors on `device`
    (kernels.ops.pdhg_burst needs them on the card; the plain version
    reads the lengths for order="kernel")."""
    def put(w: WorkList):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (w.lengths, w.order, w.items))
    return dict(row_work=put(op.rows.work), col_work=put(op.cols.work))


@dataclasses.dataclass(frozen=True)
class LanePlan:
    """Index plan for `spmv_in_kernel_order`: the stored rows grouped by
    their lane count.  Group g holds `lanes[g]` = L, the stored rows
    `rows[g]` and `slots[g]` of shape (rows, K * L), whose [:, k * L + l]
    is the flat slot that lane l adds at its step k (one past the table,
    a zero, where the row's length ends)."""

    lanes: tuple[int, ...]
    rows: tuple[torch.Tensor, ...]
    slots: tuple[torch.Tensor, ...]
    n_rows_pad: int


def lane_plan(meta: tuple, lengths: np.ndarray, device) -> LanePlan:
    """Build the LanePlan of one direction's layout and row lengths."""
    offsets, widths, bm, _ = meta
    start = row_starts(meta)
    length = np.asarray(lengths, np.int64)
    lanes = lane_count(length)
    size = int(offsets[-1] + bm * widths[-1])
    out_l, out_r, out_s = [], [], []
    for L in np.unique(lanes):
        rows = np.flatnonzero(lanes == L)
        steps = max(int((-(-length[rows] // L)).max()), 1)
        j = np.arange(steps * L)
        slots = np.where(j[None, :] < length[rows, None],
                         start[rows, None] + j[None, :], size)
        out_l.append(int(L))
        out_r.append(torch.as_tensor(rows, device=device))
        out_s.append(torch.as_tensor(slots, device=device))
    return LanePlan(lanes=tuple(out_l), rows=tuple(out_r),
                    slots=tuple(out_s), n_rows_pad=len(start))


def spmv_in_kernel_order(vec, idx, val, plan: LanePlan):
    """out[r] = sum_j val[r, j] * vec[idx[r, j]], summed in the CUDA
    kernel's order (see the note above; every product and sum rounded to
    fp32, as the kernel built with -fmad=false), so the two agree
    bitwise.  `idx`/`val` are the tables in storage order."""
    g = torch.cat([vec[idx] * val, torch.zeros(1, dtype=torch.float32,
                                               device=vec.device)])
    out = torch.empty(plan.n_rows_pad, dtype=torch.float32,
                      device=vec.device)
    for L, rows, slots in zip(plan.lanes, plan.rows, plan.slots):
        p = g[slots].view(len(rows), -1, L)
        acc = torch.zeros((len(rows), L), dtype=torch.float32,
                          device=vec.device)
        for k in range(p.shape[1]):
            acc = acc + p[:, k]
        while acc.shape[1] > 1:
            half = acc.shape[1] // 2
            acc = acc[:, :half] + acc[:, half:]
        out[rows] = acc[:, 0]
    return out


PRECISIONS = ("fp32", "bf16")
ORDERS = ("torch", "kernel")


def pdhg_update_burst(x0, y0, c, tau, xmax, q, sig, ub, keep_n, keep_m,
                      row_idx, row_val, col_idx, col_val, *,
                      row_meta: tuple, col_meta: tuple, iters: int,
                      precision: str = "fp32", order: str = "torch",
                      row_work=None, col_work=None):
    """`iters` iterations of the reference PDHG update over the blocked-
    ELL operator, plus the terminal per-row residual vector
    (|K_eq x - b| on equality rows, max(K_ub x - h, 0) on inequality
    rows).  Returns (x, y, worst), all float32.

      x' = clip(x - tau * (c + K^T y), 0, xmax),  held where keep_n
      xbar = 2 x' - x
      y' = y + sig * (K xbar - q),  max(., 0) where ub,  held where keep_m

    `precision="bf16"` stores x and y in bfloat16 between iterations,
    at the reference's cast points: x0/y0 rounded once at the start,
    each step on the fp32 widening of the stored values (xbar from the
    unrounded x'), x' and y' rounded when stored, and the outputs and
    the residual on the widened final state.  "fp32" inserts no casts.

    `order="torch"` sums each row with torch's `sum` (the plain version);
    `order="kernel"` sums it as the CUDA kernel does
    (`spmv_in_kernel_order`), which gives the kernel's output bitwise;
    it reads each row's length from `row_work` / `col_work` (as
    `burst_work` gives them), which "torch" ignores.

    This is the one-shard case of `pdhg_update_burst_sharded`: one
    shard's partial of K^T y is the whole product."""
    return pdhg_update_burst_sharded(
        x0, y0, c, tau, xmax, q, sig, ub, keep_n, keep_m, row_idx, row_val,
        col_idx, col_val, row_meta=row_meta, col_meta=col_meta, iters=iters,
        precision=precision, order=order,
        row_work=None if row_work is None else [row_work],
        col_work=None if col_work is None else [col_work])


# ---------------------------------------------------------------------------
# Sharded operator: row-block partition of [eq; ub] across ranks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedEllOperator:
    """K (m x n) packed for an S-way row-block partition: the reference's
    ShardedEllOperator, bitwise, plus each shard's work lists.

    Shard s owns the contiguous global rows [s*m_loc, (s+1)*m_loc) (the
    tail shard is padding-only past `m`).  Per shard there are two
    blocked-ELL directions, as in EllOperator but local:

      * `row_*`: one stored row per LOCAL constraint row, gathering the
        replicated x; shard s computes its own slice of K.x;
      * `col_*`: one stored row per variable, gathering the LOCAL y;
        shard s computes its partial of K^T.y, and the full product is
        the sum of the partials over shards (each nonzero lives in
        exactly one shard).

    Every shard's pack has THE SAME meta (per-block widths are the
    elementwise max across shards), so one table length and one block
    layout serve every shard; the tables are concatenated shard-major."""

    row_idx: np.ndarray        # (S * row_size,) int32, global x indices
    row_val: np.ndarray        # (S * row_size,) float32
    col_idx: np.ndarray        # (S * col_size,) int32, LOCAL y indices
    col_val: np.ndarray        # (S * col_size,) float32
    row_meta: tuple            # unified per-shard (offsets, widths, bm, m_loc)
    col_meta: tuple            # unified per-shard (offsets, widths, bm, n_pad)
    shards: int
    m: int
    n: int
    m_loc: int                 # padded rows owned by each shard
    row_work: tuple[WorkList, ...] = ()   # each shard's, the kernel's lists
    col_work: tuple[WorkList, ...] = ()

    @property
    def m_pad(self) -> int:
        """Total padded row slots across all shards."""
        return self.shards * self.m_loc

    @property
    def n_pad(self) -> int:
        """Padded variable count (the col-direction row padding)."""
        return self.col_meta[3]


@dataclasses.dataclass(frozen=True)
class ShardedEllPlan:
    """ell_pack_sharded's value-independent half: each shard's entry mask
    and both directions' plans at the unified widths (core.solver caches
    it per sparsity pattern, as it caches EllPlan)."""

    sel: tuple[np.ndarray, ...]        # per shard, its COO entries
    rows: tuple[EllPlanSide, ...]
    cols: tuple[EllPlanSide, ...]
    shards: int
    m: int
    n: int
    m_loc: int


def ell_plan_sharded(row: np.ndarray, col: np.ndarray, m: int, n: int,
                     shards: int, *, bm: int = 8,
                     align: int = 8) -> ShardedEllPlan:
    """Lay out a COO pattern for an S-way row-block partition.

    Two passes: the first lays each shard out independently to learn its
    natural per-block widths; the second re-plans every shard with the
    elementwise-max widths so all shards share one meta.  Row order
    inside each shard is the global order restricted to its rows, so
    gather row-sums match the unsharded pack bit-for-bit per row."""
    assert shards >= 1
    row = np.asarray(row, np.int64)
    col = np.asarray(col, np.int64)
    m_loc = max(-(-m // (shards * bm)), 1) * bm
    sel, parts = [], []
    for s in range(shards):
        mask = (row >= s * m_loc) & (row < (s + 1) * m_loc)
        sel.append(mask)
        parts.append((row[mask] - s * m_loc, col[mask]))
    rw = np.maximum.reduce([np.asarray(
        ell_blocks_plan(r, c, m_loc, bm=bm, align=align).widths)
        for r, c in parts])
    cw = np.maximum.reduce([np.asarray(
        ell_blocks_plan(c, r, n, bm=bm, align=align).widths)
        for r, c in parts])
    return ShardedEllPlan(
        sel=tuple(sel),
        rows=tuple(ell_blocks_plan(r, c, m_loc, bm=bm, align=align,
                                   min_widths=rw) for r, c in parts),
        cols=tuple(ell_blocks_plan(c, r, n, bm=bm, align=align,
                                   min_widths=cw) for r, c in parts),
        shards=shards, m=m, n=n, m_loc=m_loc)


def ell_fill_sharded(plan: ShardedEllPlan,
                     val: np.ndarray) -> ShardedEllOperator:
    """Fill a sharded plan with coefficient values, tables shard-major."""
    val = np.asarray(val)
    row_packs = [ell_refill(p, val[s]) for p, s in zip(plan.rows, plan.sel)]
    col_packs = [ell_refill(p, val[s]) for p, s in zip(plan.cols, plan.sel)]
    return ShardedEllOperator(
        row_idx=np.concatenate([p.idx for p in row_packs]),
        row_val=np.concatenate([p.val for p in row_packs]),
        col_idx=np.concatenate([p.idx for p in col_packs]),
        col_val=np.concatenate([p.val for p in col_packs]),
        row_meta=row_packs[0].meta, col_meta=col_packs[0].meta,
        shards=plan.shards, m=plan.m, n=plan.n, m_loc=plan.m_loc,
        row_work=tuple(p.work for p in row_packs),
        col_work=tuple(p.work for p in col_packs))


def ell_pack_sharded(row: np.ndarray, col: np.ndarray, val: np.ndarray,
                     m: int, n: int, shards: int, *, bm: int = 8,
                     align: int = 8) -> ShardedEllOperator:
    """Pack a COO operator for an S-way row-block partition, bitwise as
    the reference's ell_pack_sharded (plan, then fill; see
    ell_plan_sharded for the layout rules)."""
    return ell_fill_sharded(ell_plan_sharded(row, col, m, n, shards, bm=bm,
                                             align=align), val)


def table_len(meta: tuple) -> int:
    """Stored slots of one direction's (one shard's) blocked-ELL table."""
    offsets, widths, bm, _ = meta
    return offsets[-1] + bm * widths[-1]


def sharded_work(op: ShardedEllOperator, device, shards=None) -> dict:
    """`row_work` / `col_work` for the shards `shards` (default: all) of
    `op`: per shard its (lengths, order, items) int32 tensors on
    `device`, as burst_work gives them for one operator."""
    def put(w: WorkList):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (w.lengths, w.order, w.items))
    shards = range(op.shards) if shards is None else shards
    return dict(row_work=[put(op.row_work[s]) for s in shards],
                col_work=[put(op.col_work[s]) for s in shards])


def ordered_sum(parts):
    """((p_0 + p_1) + p_2) + ...: the partials of K^T y summed in shard
    order, the one summation order of a sharded burst on every rank."""
    g = parts[0]
    for p in parts[1:]:
        g = g + p
    return g


def pdhg_update_burst_sharded(x0, y0, c, tau, xmax, q, sig, ub, keep_n,
                              keep_m, row_idx, row_val, col_idx, col_val, *,
                              row_meta: tuple, col_meta: tuple, iters: int,
                              reduce=None, precision: str = "fp32",
                              order: str = "torch", row_work=None,
                              col_work=None):
    """The plain body of the row-sharded burst: the reference's
    pdhg_update_burst_sharded, with the same update, cast points and
    orders as pdhg_update_burst.

    x-side arrays (x0, c, tau, xmax, keep_n) are replicated (n_pad).
    y-side arrays (y0, q, sig, ub, keep_m, each k * m_loc) and the four
    tables (each k shards' tables, shard-major, as ell_pack_sharded lays
    them out) hold the k consecutive shards this caller owns:

      * K.x: each shard computes its rows from the replicated x;
      * K^T.y: each shard computes its partial, and `reduce(parts)` (the
        caller's list of k partials) returns the sum over all S shards.
        `reduce=None` means the caller holds every shard (k = S) and
        sums them with `ordered_sum`: a single process steps the S
        shards in lockstep, bitwise as S ranks whose `reduce` gathers
        the partials and takes the same ordered sum.

    Returns (x, y_local, worst_local): x identical on every rank, y and
    the residual vector for the caller's rows.  `order="kernel"` sums
    each row as the CUDA kernel does and reads each shard's row lengths
    from `row_work` / `col_work` (k triples each, as sharded_work gives
    them)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"have {PRECISIONS}")
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}; have {ORDERS}")
    dev = x0.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    m_loc = row_meta[3]
    k = y0.shape[0] // m_loc
    rsize, csize = table_len(row_meta), table_len(col_meta)
    tables = [(row_idx[s * rsize:(s + 1) * rsize],
               row_val[s * rsize:(s + 1) * rsize],
               col_idx[s * csize:(s + 1) * csize],
               col_val[s * csize:(s + 1) * csize]) for s in range(k)]
    if order == "kernel":
        if row_work is None or col_work is None:
            raise ValueError('order="kernel" needs row_work and col_work')
        plans = [(lane_plan(row_meta, row_work[s][0].cpu().numpy(), dev),
                  lane_plan(col_meta, col_work[s][0].cpu().numpy(), dev))
                 for s in range(k)]

        def Kx_s(s, x):
            return spmv_in_kernel_order(x, tables[s][0], tables[s][1],
                                        plans[s][0])

        def KTy_s(s, y):
            return spmv_in_kernel_order(y, tables[s][2], tables[s][3],
                                        plans[s][1])
    else:
        rows_g = width_groups(row_meta, dev)
        cols_g = width_groups(col_meta, dev)
        grouped = [(ri[rows_g.perm], rv[rows_g.perm], ci[cols_g.perm],
                    cv[cols_g.perm]) for ri, rv, ci, cv in tables]

        def Kx_s(s, x):
            return spmv_blocks(x, grouped[s][0], grouped[s][1], rows_g)

        def KTy_s(s, y):
            return spmv_blocks(y, grouped[s][2], grouped[s][3], cols_g)

    def Kx(x):
        return torch.cat([Kx_s(s, x) for s in range(k)])

    def KTy(y):
        parts = [KTy_s(s, y[s * m_loc:(s + 1) * m_loc]) for s in range(k)]
        return ordered_sum(parts) if reduce is None else reduce(parts)

    def update(x, y):
        x_new = torch.minimum(torch.maximum(x - tau * (c + KTy(y)), zero),
                              xmax)
        x_new = torch.where(keep_n, x, x_new)
        x_bar = 2.0 * x_new - x
        y_new = y + sig * (Kx(x_bar) - q)
        y_new = torch.where(ub, torch.maximum(y_new, zero), y_new)
        y_new = torch.where(keep_m, y, y_new)
        return x_new, y_new

    if precision == "bf16":
        x, y = x0.to(torch.bfloat16), y0.to(torch.bfloat16)
        for _ in range(iters):
            x_new, y_new = update(x.float(), y.float())
            x, y = x_new.to(torch.bfloat16), y_new.to(torch.bfloat16)
        x, y = x.float(), y.float()
    else:
        x, y = x0, y0
        for _ in range(iters):
            x, y = update(x, y)
    r = Kx(x) - q
    return x, y, torch.where(ub, torch.maximum(r, zero), torch.abs(r))
