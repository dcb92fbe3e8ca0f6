"""The COO operator's plan and the plain PyTorch PDHG burst over it.

The reference's default PDHG lowering (`backend="xla"`,
`repro.core.solver._pdhg_ops` and the loops over it) keeps K in COO and
runs both mat-vecs as XLA scatter-adds.  On a CPU those follow one fixed
order, which this module writes down (fp32 throughout):

  1. tau_j = 1 / max(sum_e |val_e|, 1e-12) over column j's entries and
     sig_i the same over row i's, each a sequential fp32 sum in COO
     entry order from 0;
  2. g = c + K^T y: column j starts from c_j and adds the rounded
     products val_e * y[row_e] one at a time in COO entry order;
  3. x' = clip(fma(-tau, g, x), 0, xmax): x - tau g rounded once;
  4. xbar = 2 x' - x;
  5. K xbar: row i starts from 0 and adds its rounded products in COO
     entry order; r = K xbar - q;
  6. y' = fma(sig, r, y), rounded once, then max(., 0) on the
     inequality rows.

Freeze masks hold coordinates as in `_pdhg_run_adaptive` (x' = x where
keep_n, y' = y where keep_m), and the terminal residual is |K x - q| on
equality rows and max(K x - q, 0) on inequalities, K x summed as in 5.

This module holds:

  * the plan (`coo_plan`, `coo_fill`): for each direction the outputs
    (columns for K^T y, rows for K x) in the card's work order, the
    long ones first (more than `LONG` entries, longest first: a warp
    each, or a block each past `CHUNK_ENTRIES`) and then the rest in
    index order, cut into chunks of at most `CHUNK_OUTPUTS` outputs and
    `CHUNK_ENTRIES` entries (a warp each);
    and a stable permutation of the COO entries grouped by output in
    that order, so each output's entries stay contiguous and in COO
    order.  The tiers change which warp sums an output, never the order
    of its sum.  Built once per sparsity pattern, refilled with values
    in O(nnz);
  * the plain version of the burst (`coo_update_burst`) and of the
    residual (`coo_residual`): sequential `index_add_` on 1-D CPU
    tensors (one add an entry, in entry order), and the two contracted
    updates as `fma32`.  The CPU tests run it and hold it to the
    reference; the card holds the hand kernel
    (kernels/csrc/pdhg_coo.cu, wrapped by kernels.ops.pdhg_coo_burst)
    to it bitwise.  It runs on CPU tensors only: torch's CUDA
    `index_add_` adds with atomics, in no fixed order.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

# an output with more entries than this is long: a warp of its own on the
# card (kernels/csrc/pdhg_coo.cu), or a block past CHUNK_ENTRIES
LONG = 32
# a chunk of the other outputs, also a warp's: one output a lane, and the
# chunk's products staged in the warp's shared-memory buffer, which holds
# CHUNK_ENTRIES, 16 a lane (the kernel's kBuf; ops checks the two agree)
CHUNK_OUTPUTS = 32
CHUNK_ENTRIES = 512


@dataclasses.dataclass(frozen=True)
class CooPlanSide:
    """One direction of a COO operator, values excluded: the outputs in
    work order (positions), and the entries grouped by position in COO
    order within each output."""

    perm: np.ndarray     # (nnz,) int64 stable sort of the entries by position
    off: np.ndarray      # (n_out + 1,) int32 each position's first entry
    idx: np.ndarray      # (nnz,) int32 the index each sorted entry gathers
    out: np.ndarray      # (nnz,) int64 the output of each sorted entry
    order: np.ndarray    # (n_out,) int32 the output at each position
    n_long: int          # positions [0, n_long): the long outputs
    n_block: int         # [0, n_block): those past CHUNK_ENTRIES
    chunk: np.ndarray    # (n_chunks + 1,) int32 each chunk's first position


@dataclasses.dataclass(frozen=True)
class CooPlan:
    """Both directions of a COO sparsity pattern: `cols` gathers y to
    produce K^T y (one output a variable), `rows` gathers x to produce
    K x (one output a constraint)."""

    cols: CooPlanSide
    rows: CooPlanSide
    m: int
    n: int


def _chunks(counts: np.ndarray, first: int) -> np.ndarray:
    """Cut positions [first, len(counts)) of entry counts (each at most
    LONG) into runs of at most CHUNK_OUTPUTS outputs and CHUNK_ENTRIES
    entries, greedily in order; returns each run's first position and
    the end."""
    starts = []
    outs = entries = 0
    for p, k in enumerate(counts[first:].tolist(), first):
        if p == first or outs == CHUNK_OUTPUTS or entries + k > CHUNK_ENTRIES:
            starts.append(p)
            outs = entries = 0
        outs += 1
        entries += k
    starts.append(len(counts))
    return np.asarray(starts, np.int32)


def _plan_side(key: np.ndarray, other: np.ndarray, n_out: int) -> CooPlanSide:
    key = np.asarray(key, np.int64)
    counts = np.bincount(key, minlength=n_out)[:n_out]
    outs = np.arange(n_out)
    is_long = counts > LONG
    # long outputs longest first (ties by index), then the rest by index
    long_ = outs[is_long][np.argsort(-counts[is_long], kind="stable")]
    order = np.concatenate([long_, outs[~is_long]]).astype(np.int32)
    pos = np.empty(n_out, np.int64)
    pos[order] = np.arange(n_out)
    # stable: an output's entries keep their COO order
    perm = np.argsort(pos[key], kind="stable")
    by_pos = counts[order]
    off = np.concatenate([[0], np.cumsum(by_pos)]).astype(np.int32)
    return CooPlanSide(
        perm=perm, off=off,
        idx=np.asarray(other, np.int64)[perm].astype(np.int32),
        out=key[perm], order=order, n_long=len(long_),
        n_block=int(np.count_nonzero(counts > CHUNK_ENTRIES)),
        chunk=_chunks(by_pos, len(long_)))


def coo_plan(row: np.ndarray, col: np.ndarray, m: int, n: int) -> CooPlan:
    """Plan a COO pattern (m x n) in both directions."""
    if len(row) and (np.max(row) >= m or np.max(col) >= n
                     or np.min(row) < 0 or np.min(col) < 0):
        raise ValueError(f"COO indices out of range for a {m} x {n} "
                         f"operator")
    return CooPlan(cols=_plan_side(col, row, n), rows=_plan_side(row, col, m),
                   m=m, n=n)


@dataclasses.dataclass(frozen=True)
class CooOperator:
    """A planned operator with its values: each direction's values in
    its plan's order (float32), and the diagonal preconditioners tau (n)
    and sig (m) of step 1."""

    plan: CooPlan
    col_val: np.ndarray
    row_val: np.ndarray
    tau: np.ndarray
    sig: np.ndarray


def coo_fill(plan: CooPlan, val: np.ndarray) -> CooOperator:
    """Refresh a plan with coefficient values: both directions' values
    and tau/sig summed in float32 in COO entry order (np.add.at adds one
    entry at a time, in order)."""
    v = np.asarray(val).astype(np.float32)
    a = np.abs(v)
    # each output's entries in plan order are its entries in COO order
    col_sum = np.zeros(plan.n, np.float32)
    np.add.at(col_sum, plan.cols.out, a[plan.cols.perm])
    row_sum = np.zeros(plan.m, np.float32)
    np.add.at(row_sum, plan.rows.out, a[plan.rows.perm])
    one, floor = np.float32(1.0), np.float32(1e-12)
    return CooOperator(plan=plan, col_val=v[plan.cols.perm],
                       row_val=v[plan.rows.perm],
                       tau=one / np.maximum(col_sum, floor),
                       sig=one / np.maximum(row_sum, floor))


class CooDirection(NamedTuple):
    """One direction of a filled operator as tensors on a device (the
    plan side's fields): the kernel reads order/off/idx/val/chunk,
    n_long and n_block, the plain version idx/val/out."""

    off: torch.Tensor     # (n_out + 1,) int32
    idx: torch.Tensor     # (nnz,) int32
    val: torch.Tensor     # (nnz,) float32
    out: torch.Tensor     # (nnz,) int64
    order: torch.Tensor   # (n_out,) int32
    chunk: torch.Tensor   # (n_chunks + 1,) int32
    n_long: int
    n_block: int

    @property
    def n_out(self) -> int:
        return self.off.shape[0] - 1

    @property
    def n_chunks(self) -> int:
        return self.chunk.shape[0] - 1


def coo_directions(op: CooOperator, device) -> tuple[CooDirection,
                                                     CooDirection]:
    """(cols, rows) of a filled operator on `device`."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def side(s: CooPlanSide, val):
        return CooDirection(put(s.off), put(s.idx), put(val), put(s.out),
                            put(s.order), put(s.chunk), s.n_long,
                            s.n_block)

    return side(op.plan.cols, op.col_val), side(op.plan.rows, op.row_val)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 tensors, rounded to float32 once, as a fused
    multiply-add rounds it.  The product of two float32 numbers is exact
    in float64; the sum there is made round-to-odd (the exact error from
    TwoSum, and one step toward it when the rounded sum is even), and
    round-to-odd at 53 bits followed by one rounding to 24 bits is the
    correctly rounded result (53 >= 2 * 24 + 2), so no double rounding
    can occur."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    step = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(step, torch.nextafter(s, toward), s).float()


def _sums(start: torch.Tensor, d: CooDirection, vec: torch.Tensor):
    """start[o] + the rounded products of output o, added one at a time
    in entry order (sequential index_add_ on CPU tensors)."""
    if start.device.type != "cpu":
        raise ValueError("the plain COO sums run on CPU tensors only: "
                         "torch's CUDA index_add_ adds in no fixed order")
    return start.clone().index_add_(0, d.out, d.val * vec[d.idx.long()])


def coo_residual(x, q, ub, rows: CooDirection):
    """Per-row residual of x: |K x - q| on equality rows, max(K x - q, 0)
    where ub, K x summed from 0 in entry order."""
    r = _sums(torch.zeros_like(q), rows, x) - q
    return torch.where(ub, r.clamp_min(0.0), r.abs())


def coo_update_burst(x0, y0, c, tau, xmax, q, sig, ub, keep_n, keep_m,
                     cols: CooDirection, rows: CooDirection, *, iters: int):
    """`iters` PDHG steps in the order of the module docstring, then the
    terminal residual; returns (x, y, worst), float32 CPU tensors.

      x' = clip(fma(-tau, c + K^T y, x), 0, xmax),  held where keep_n
      xbar = 2 x' - x
      y' = fma(sig, K xbar - q, y),  max(., 0) where ub,  held where keep_m
    """
    x, y = x0, y0
    for _ in range(iters):
        g = _sums(c, cols, y)
        xn = torch.minimum(fma32(-tau, g, x).clamp_min(0.0), xmax)
        xn = torch.where(keep_n, x, xn)
        x_bar = 2.0 * xn - x
        yn = fma32(sig, _sums(torch.zeros_like(q), rows, x_bar) - q, y)
        yn = torch.where(ub, yn.clamp_min(0.0), yn)
        y = torch.where(keep_m, y, yn)
        x = xn
    return x, y, coo_residual(x, q, ub, rows)
