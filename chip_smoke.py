#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and hold its kernel to account.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    PYTHONPATH=src python3 chip_smoke.py [--sweep-out DIR]

Phases, in order; any failure ends the script with a non-zero exit code:

  1. card check: a CUDA device, its name and power limit, TF32 off;
  2. build: the three CUDA kernels from src/repro_torch/kernels/csrc (the
     burst, attention and scan kernels; one nvcc each, started together);
  3. kernel vs plain version on the card: random blocked-ELL operators
     (frozen coordinates, a mix of inequality rows) and the full-size LP,
     at 1 and 500 iterations: bitwise equal to the kernel-order model
     (the plain version summing each row as the kernel does), bitwise
     equal on two grids (as many blocks as fit, one block an SM), within
     the plain version's tolerance; a launch on more blocks than fit
     raises;
  4. main path, paper topologies: solve_fast on the card for six paper
     DCNs x {energy, time}; certificates, agreement with the port's own
     CPU solve, and the committed pins of tests/golden/metrics.json;
  5. main path at full size: fat-tree k=16 (1,024 servers) x {energy,
     time}, each solved twice on the card; certificates, bitwise repeat,
     and the kernel's launch count; the profiler sees one burst kernel
     launch a burst and no other kernel of the burst;
  6. times at the full-size shapes: the kernel (as many blocks as fit,
     and one block an SM), its plain version, two CSR mat-vecs as a
     library yardstick, and the bound;
  7. build of the flash-attention kernel (phase 2): seconds, and each
     template's registers and spills (the bf16 tensor-core kernel and the
     fp32 SIMT kernel, one template per padded head dim);
  8. attention kernel vs its plain version on the card: the grid of
     tests/test_kernels.py, a danube-shaped windowed case, the phi4 serving
     shape and recurrentgemma's (hd 256, one kv head, window 2048), a
     ragged S = T = 1000, two non-causal cases, hd 100 (zero-padded to
     104 by the wrapper) and B*H = 65,600 (past the 65,535 limit of a
     grid's y axis), each in fp32 and bf16,
     each element within its tolerance (fp32: 2e-5 + 2e-5 of the element;
     bf16: one bf16 place more), two launches bitwise equal; an attention
     that drops the last kv tile, and one that rounds p once to bf16 in
     p.v, must fail the same check;
  9. serving path at full width: `launch.serve.main` on phi4-mini-3.8b
     (batch 4, prompt 2048, 32 tokens), run twice: 32 kernel launches a
     prefill, identical tokens, finite logits; in every layer the
     attention sublayer through the kernel agrees with it through the
     plain version within bf16 places, and fails with the dropped tile;
     then h2o-danube-3-4b cut to 4 layers (batch 1, prompt 6144, 8 tokens)
     for the window, hd=120 and the ring-buffer cache;
 10. times at the serving shapes: the attention kernel, its plain
     version, torch's scaled_dot_product_attention as a library
     yardstick, the bound and the useful TFLOP/s reached; prefill wall,
     decode ms a token, and the device's busy share of one prefill;
 11. the bf16-storage burst (pdhg_burst_bf16) vs its plain version on
     phase 3's operators at 1 and 500 iterations: bitwise equal to the
     kernel-order model and on two grids, every output on the bf16 grid
     (the fp32 kernel's is not), one bf16 place after one iteration;
 12. bf16 main path: solve_fast(precision="bf16") on the six paper
     cells x {energy, time}, held to the card's fp32 solves as
     tests/test_precision.py holds them, then fat-tree k=16;
 13. batched path at full size: fat-tree k=16, seeds 0-7, through
     solve_fast_batch (the adaptive driver): certificates, against the
     solo solves, adaptive=False against solve_lp, 8 identical copies
     bitwise equal, a frozen member's iterates, a bitwise repeat;
 14. the sweep CLI on the card: the reference's default grid over the
     six paper topologies (288 rows), certified, against the committed
     results/sweep/results.csv and against the port's CPU run of 8 rows,
     which in the kernel's summation order must give the card's rows
     bitwise;
 15. times at the batched and bf16 shapes: the fp32 burst at the
     8-instance stack, the bf16 burst at the single flagship shape, each
     on both grids, with its plain version, two CSR mat-vecs and its
     bound; the batch's wall against 8 solo solves and its device busy
     share;
 16. the RG-LRU scan kernel vs its plain version on the card: the grid of
     tests/test_kernels.py, R = 200, B = 65,600 (past the 65,535 limit of
     a grid's y axis), S = 1 and 4097, R = 202 and 7, B = 1 at the
     serving S and R, a and b 4 bytes past a 16-byte boundary, with and
     without h0, and the serving shape (4, 4096, 2560) with a and b as
     the model makes them; bitwise equal, two launches bitwise equal; a
     ring larger than the card's shared memory raises; a scan that
     ignores h0, one that drops the last step and one that rounds a*h +
     b once (a fused multiply-add) must fail the same check;
 17. serving path at full width: `launch.serve.main` on recurrentgemma-2b
     (26 layers, batch 4, prompt 4096, 32 tokens), run twice: 18 scan and
     8 attention launches a prefill, identical tokens, finite logits; in
     every layer the recurrent or attention sublayer through its kernel
     agrees with it through the plain version within bf16 places, and
     fails with the dropped step or the dropped kv tile;
 18. times at recurrentgemma's shapes: the scan kernel (its TB/s, its
     registers, shared memory and blocks an SM, its time at the ring's
     neighbouring stage lengths and at B = 1), its plain version and its
     bound (no library call computes the recurrence); attention at
     hd 256 against SDPA with a window mask, its bound and the useful
     TFLOP/s reached; prefill wall,
     decode ms a token, and the device's busy share of one prefill and one
     decode step by kernel.

The last lines are one JSON object describing the kernels, the card's
name and power limit, and `{"ok": true, "device": {...}}`.  Imports
torch, numpy, scipy and repro_torch only.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

GOLDEN = ROOT / "tests" / "golden" / "metrics.json"
PAPER_TOPOS = ("spine-leaf", "fat-tree", "bcube", "dcell", "pon3", "pon5")
GOLDEN_TOPOS = ("spine-leaf", "pon3")
OBJECTIVES = ("energy", "time")
# the golden grid's traffic (tests/test_golden_metrics.py)
GOLDEN_PATTERN = dict(n_map=4, n_reduce=3, total_gbits=8.0)
# the flagship size the repo benchmarks (benchmarks/scale_bench.py)
FULL = ("fat-tree", dict(k=16), dict(n_map=20, n_reduce=12,
                                     total_gbits=120.0), 0)
METRIC_RTOL = 1e-4
# one iteration: the kernel and the plain version differ only in the
# order of each row's sum, so they agree to a few fp32 ulps of the
# vector's scale
RTOL_1 = 1e-5
# 500 iterations: that drift in summation order compounds over the
# iterations, so the bound is looser, relative to the iterate's scale
ATOL_500 = 1e-3
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and
# fp32 (non-tensor-core) operations/s
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
REPLACES = "src/repro/kernels/pdhg_spmv.py:333"
# the bf16-storage branch of the same pallas_call's body
BF16_REPLACES = "src/repro/kernels/pdhg_spmv.py:292"
SOURCE = "src/repro_torch/kernels/csrc/pdhg_burst.cu"
# one bf16 place: 2**-7 of a value (8 significant bits)
BF16_PLACE = 2.0 ** -7
# attention kernel against its plain version, element by element:
# |kernel - plain| <= atol + rtol * |plain|.  Both compute in fp32 and
# differ in the order of the sums (fp32: the tolerance of
# tests/test_kernels.py); in bf16 each rounds that fp32 result once, so
# the two may also differ by one bf16 place.
FA_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-5, 2e-5 + BF16_PLACE)}
# the bf16 tensor-core peak (H100 SXM data sheet, dense) for the bound
BF16_OPS_S = 989e12
FA_REPLACES = "src/repro/kernels/flash_attention.py:75"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
# (name, B, S, H, Hkv, hd, window, softcap, causal); each in both dtypes
FA_CASES = [
    ("grid-1", 2, 512, 4, 2, 64, 0, 0.0, True),
    ("grid-2", 2, 512, 4, 4, 128, 0, 50.0, True),
    ("grid-3", 2, 1024, 8, 1, 64, 256, 0.0, True),
    ("grid-4", 2, 512, 6, 2, 80, 0, 0.0, True),
    ("danube", 1, 6144, 32, 8, 120, 4096, 0.0, True),
    ("phi4-serve", 4, 2048, 24, 8, 128, 0, 0.0, True),
    ("rgemma-serve", 4, 4096, 10, 1, 256, 2048, 0.0, True),
    # S and T not a multiple of any tile: ragged rows and keys
    ("ragged", 2, 1000, 8, 2, 128, 0, 0.0, True),
    # no causal mask: every kv tile visited, with and without a window
    ("non-causal", 2, 1000, 6, 2, 80, 0, 0.0, False),
    ("non-causal-window", 1, 1000, 4, 1, 256, 300, 30.0, False),
    # hd not a multiple of 8: the wrapper zero-pads it to 104
    ("hd-100", 2, 512, 4, 1, 100, 128, 30.0, True),
    # B*H = 65,600 with a short S: (batch, head) past a y axis's 65,535
    ("bh-65600", 4100, 16, 16, 4, 32, 0, 0.0, True),
]
FA_DTYPES = ("float32", "bfloat16")
SERVE_ARGS = ["--arch", "phi4-mini-3.8b", "--batch", "4", "--prompt-len",
              "2048", "--gen", "32", "--impl", "kernel"]
# keys the negative control drops: the fp32 kernel's kv tile, two or more
# of the bf16 kernel's (kernels/csrc/flash_attention.cu)
KV_TILE = 64
# bf16 storage against fp32 (tests/test_precision.py): energy-objective
# metrics within 1e-3, time-objective completion within 1.25x
BF16_METRIC_RTOL = 1e-3
BF16_COMPLETION_RATIO = 1.25
# the batched path: the flagship problem at these seeds
BATCH_SEEDS = tuple(range(8))
# adaptive=False against solve_lp (tests/test_solver_batch.py:38)
BATCH_X_ATOL = 1e-6
# the sweep: the reference's default grid over the six paper topologies,
# held to the committed results of the reference's run (xla lowering)
SWEEP_ARGS = ["--topos", ",".join(PAPER_TOPOS), "--oracle-check", "0"]
SWEEP_RESULTS = ROOT / "results" / "sweep" / "results.csv"
SWEEP_RTOL = 1e-4
# No row of that grid is one whose committed number the reference's own
# pallas lowering misses: the port's CPU run of the grid (the plain
# version) holds all 288 rows within 1.3e-6.  Listed here are the rows
# whose card result misses the committed number by more than SWEEP_RTOL
# because of the kernel's summation order alone: at this row the lane
# split moves the LP iterate by a few fp32 ulps, enough to flip one
# discrete choice of the host's packing (1 J of 2152).  Each is checked
# on every run: the plain
# version summing in the kernel's order reproduces the card's row
# bitwise, and summing in its own order lands within SWEEP_RTOL of the
# committed number.  key -> the expected relative difference.
SWEEP_ORDER_SENSITIVE = {("spine-leaf", "energy", "skew", 5): 4.6468e-4}
SWEEP_CPU_CELLS = dict(topos=("spine-leaf", "pon3"), patterns=("uniform",),
                       seeds=(0, 1))
# the RG-LRU scan: the TPU kernel it replaces and its source
SCAN_REPLACES = "src/repro/kernels/rglru_scan.py:33"
SCAN_SOURCE = "src/repro_torch/kernels/csrc/rglru_scan.cu"
# (B, S, R): the grid of tests/test_kernels.py, then R off the 128 lanes,
# then B past the 65,535 limit of a grid's y axis; then the ring's edges:
# S = 1 and S = 4097 (no multiple of a stage), R = 202 and R = 7 (no
# multiple of 4: 4-byte copies; R < 32: one ragged group), and B = 1 at
# the serving S and R (80 groups for 132 SMs)
SCAN_CASES = [(b, s, r) for b in (1, 2, 3) for s in (64, 256)
              for r in (128, 256, 384)] + [(2, 256, 200), (3, 64, 200),
                                           (65600, 8, 16), (2, 1, 2560),
                                           (2, 4097, 2560), (2, 97, 202),
                                           (3, 100, 7), (1, 4096, 2560)]
# a and b as contiguous views 4 bytes past a 16-byte boundary (4-byte
# copies at an R that would take 16-byte ones)
SCAN_MISALIGNED = [(2, 1000, 2560), (3, 33, 202)]
# recurrentgemma-2b's prefill scan at the serving shape below
SCAN_SERVE = (4, 4096, 2560)
RGEMMA_ARGS = ["--arch", "recurrentgemma-2b", "--batch", "4", "--prompt-len",
               "4096", "--gen", "32", "--impl", "kernel"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def say(*a):
    print(*a, flush=True)


def require(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def problem(topo_name, topo_kw, traffic_kw, slack):
    return problems(topo_name, topo_kw, traffic_kw, slack, (0,))[0]


def problems(topo_name, topo_kw, traffic_kw, slack, seeds):
    """One problem per seed on one shared topology, the sweep's way."""
    from repro_torch.core import timeslot, topology, traffic
    topo = topology.build(topo_name, **topo_kw)
    cfs = traffic.generate_batch(
        topo, traffic.pattern("uniform", **traffic_kw), seeds)
    return [timeslot.ScheduleProblem(
        topo, cf, n_slots=timeslot.suggest_n_slots(topo, cf),
        path_slack=slack) for cf in cfs]


def metrics_of(r) -> dict:
    m = r.metrics
    return {"energy_j": float(m.energy_j),
            "completion_s": float(m.completion_s),
            "fairness_term": float(m.fairness_term),
            "served_gbits": float(m.served.sum())}


def close(a: dict, b: dict, rtol: float) -> bool:
    return all(math.isclose(a[k], b[k], rel_tol=rtol, abs_tol=1e-9)
               for k in a)


def restarts(iterations: int, iters: int) -> int:
    """Rungs of the restart ladder past the first (rung k runs
    iters * 2**k iterations)."""
    return round(math.log2(iterations / iters + 1)) - 1


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

def random_burst_args(seed, m, n, m_eq, dev):
    """A random blocked-ELL LP with a few very wide rows (every row and
    column holds at least one entry), 20% of the coordinates frozen, and
    rows [m_eq, m) inequalities."""
    import numpy as np
    import torch
    from repro_torch.kernels import pdhg_spmv
    rng = np.random.default_rng(seed)
    nnz = 8 * m
    row = np.concatenate([rng.integers(0, m, nnz),
                          np.repeat(rng.integers(0, m, 3), 120),
                          np.arange(m), np.arange(n) % m])
    col = np.concatenate([rng.integers(0, n, nnz + 360),
                          np.arange(m) % n, np.arange(n)])
    val = rng.normal(size=len(row))
    op = pdhg_spmv.ell_pack(row, col, val, m, n)
    cs = np.zeros(n)
    np.add.at(cs, col, np.abs(val))
    rs = np.zeros(m)
    np.add.at(rs, row, np.abs(val))
    keep_n = np.zeros(op.n_pad, bool)
    keep_n[:n] = rng.random(n) < 0.2
    keep_m = np.zeros(op.m_pad, bool)
    keep_m[:m] = rng.random(m) < 0.2

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def padn(a):
        return t(np.pad(np.asarray(a, np.float32), (0, op.n_pad - n)))

    def padm(a):
        return t(np.pad(np.asarray(a, np.float32), (0, op.m_pad - m)))

    vecs = (padn(rng.normal(size=n)), padn(1 / np.maximum(cs, 1e-12)),
            padn(rng.uniform(0.5, 4.0, n)), padm(rng.normal(size=m)),
            padm(1 / np.maximum(rs, 1e-12)),
            t(np.pad(np.arange(m) >= m_eq, (0, op.m_pad - m),
                     constant_values=True)),
            t(keep_n), t(keep_m))
    ell = tuple(t(a) for a in (op.rows.idx, op.rows.val, op.cols.idx,
                               op.cols.val))
    start = (padn(rng.uniform(0.0, 1.0, n)), padm(rng.normal(size=m)))
    return op, vecs + ell + start


def lp_burst_args(lp, dev):
    """The solver's own packing of a routing LP, started from a seeded
    random point inside the box (a cold start from zero leaves x at zero
    after one step, which would compare nothing)."""
    import numpy as np
    import torch
    from repro_torch.core import solver
    xmax = np.where(np.isfinite(lp.xmax), lp.xmax, 1e12)
    cscale = max(float(np.abs(lp.c).max(initial=0.0)), 1e-12)
    op, vecs, ell = solver._pack_ell(lp.c / cscale, lp.row, lp.col, lp.val,
                                     lp.b, lp.h, xmax, lp.m_eq, dev)
    keep = (torch.zeros(op.n_pad, dtype=torch.bool, device=dev),
            torch.zeros(op.m_pad, dtype=torch.bool, device=dev))
    rng = np.random.default_rng(0)
    x0 = np.zeros(op.n_pad, np.float32)
    x0[:lp.n] = rng.uniform(0.0, 1.0, lp.n) * np.minimum(xmax, 1.0)
    y0 = np.zeros(op.m_pad, np.float32)
    y0[:lp.m] = rng.normal(0.0, 0.1, lp.m)
    start = (torch.from_numpy(x0).to(dev), torch.from_numpy(y0).to(dev))
    return op, vecs + keep + ell + start


def layout(op, dev) -> dict:
    """The burst's layout keywords for `op`: both directions' meta and
    their work lists on `dev` (kernels.pdhg_spmv.burst_work)."""
    from repro_torch.kernels import pdhg_spmv
    return dict(row_meta=op.rows.meta, col_meta=op.cols.meta,
                **pdhg_spmv.burst_work(op, dev))


def check_kernel_order(label, op, args, iters, precision, k, sms) -> None:
    """The kernel's outputs `k` (a launch on as many blocks as fit)
    against the kernel-order model (pdhg_update_burst(order="kernel"):
    each row summed as the kernel sums it) and against a launch on one
    block an SM, both bitwise over (x, y, worst)."""
    import torch
    from repro_torch.kernels import ops, pdhg_spmv
    kw = dict(layout(op, args[0].device), iters=iters, precision=precision)
    model = pdhg_spmv.pdhg_update_burst(args[12], args[13], *args[:12], **kw,
                                        order="kernel")
    one = ops.pdhg_burst(*args, **kw, _blocks=sms)
    torch.cuda.synchronize()
    same_model = all(torch.equal(a, b) for a, b in zip(k, model))
    same_grid = all(torch.equal(a, b) for a, b in zip(k, one))
    say(f"  {label} {precision} iters={iters}: bitwise equal to the "
        f"kernel-order model: {same_model}; to the kernel on {sms} blocks "
        f"(one an SM): {same_grid}")
    require(same_model, f"{label} {precision} iters={iters}: the kernel "
                        f"differs from the kernel-order model by "
                        f"{max(float((a - b).abs().max()) for a, b in zip(k, model)):.3e}")
    require(same_grid, f"{label} {precision} iters={iters}: two grids "
                       f"give different bits")


def compare_burst(label, op, args, iters, sms) -> tuple[float, bool]:
    """Run the kernel and the plain version on the same card inputs, and
    hold the kernel bitwise to its summation-order model and to itself on
    one block an SM (check_kernel_order); returns the largest absolute
    difference over (x, y, worst) and whether the plain version (torch's
    sum order) differs from the kernel bitwise."""
    import torch
    from repro_torch.kernels import ops, pdhg_spmv
    kw = dict(layout(op, args[0].device), iters=iters)
    k = ops.pdhg_burst(*args, **kw)
    p = pdhg_spmv.pdhg_update_burst(args[12], args[13], *args[:12], **kw)
    torch.cuda.synchronize()
    check_kernel_order(label, op, args, iters, "fp32", k, sms)
    x_scale = float(p[0].abs().max())
    worst_err = 0.0
    for name, kv, pv in zip(("x", "y", "worst"), k, p):
        err = float((kv - pv).abs().max())
        scale = float(pv.abs().max())
        if iters == 1:
            lim = RTOL_1 * max(scale, 1e-30)
        else:
            lim = ATOL_500 * max(scale, x_scale)
        say(f"  {label} iters={iters} {name}: max|kernel-plain|={err:.3e} "
            f"limit={lim:.3e} (scale {scale:.3e})")
        require(bool(torch.isfinite(kv).all()), f"{label}: {name} not finite")
        require(err <= lim, f"{label} iters={iters}: {name} differs by "
                            f"{err:.3e} > {lim:.3e}")
        worst_err = max(worst_err, err)
    # padded slots stay pinned at zero
    require(bool((k[0][op.n:] == 0).all() and (k[1][op.m:] == 0).all()),
            f"{label}: a padded slot moved")
    return worst_err, not all(torch.equal(a, b) for a, b in zip(k, p))


# ---------------------------------------------------------------------------
# phase 6: times at the full-size shapes
# ---------------------------------------------------------------------------

def time_events(fn, reps: int) -> float:
    """Milliseconds per call of `fn` on the card, CUDA events around
    `reps` calls after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def burst_bound(op, nnz: int, it: int = 4,
                padded: bool = False) -> tuple[float, str, int, int]:
    """Least time of one PDHG iteration on this card: each operand of
    the iteration read once and each output written once (the ELL
    tables' real entries, index and value, in both directions, and their
    block meta; the x-side and y-side vectors and masks; x' and y'
    written), against the operations the real entries need (a multiply
    and an add per nonzero in each direction, plus the elementwise
    updates).  The padding past each row's entries is not counted: the
    function does not need it and the kernel does not read it
    (`padded=True` counts every stored slot instead, the figure earlier
    bounds used).  `it` is the bytes of a stored iterate (4 for fp32, 2
    for bf16 storage).  Returns (ms, bound_by, bytes, ops)."""
    f4, b1, i8 = 4, 1, 8
    entries = int(op.rows.work.lengths.sum()) + int(op.cols.work.lengths.sum())
    require(entries == 2 * nnz, f"the work lists hold {entries} entries, "
                                f"not 2 x nnz = {2 * nnz}")
    tables = 8 * (len(op.rows.idx) + len(op.cols.idx) if padded
                  else entries)
    meta = (i8 + f4) * (len(op.rows.widths) + len(op.cols.widths))
    # x side: c, tau, xmax, x (read), keep_n (read), x' (write)
    xside = op.n_pad * (3 * f4 + it + b1 + it)
    # y side: q, sig, y (read), ub, keep_m (read), y' (write)
    yside = op.m_pad * (2 * f4 + it + 2 * b1 + it)
    nbytes = tables + meta + xside + yside
    # K^T y and K xbar: 2 ops per nonzero each; primal: add, mul, sub,
    # max, min, then 2x' - x (2); dual: sub, mul, add, max
    nops = 4 * nnz + 7 * op.n + 4 * op.m
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = nops / FP32_OPS_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, nops)


def profile_device(fn) -> dict | None:
    """Device time by kernel name over one call of `fn`, from
    torch.profiler: {name: (launches, total microseconds)}, or None when
    the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue          # host-side ops; their kernels are listed too
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0 and e.count > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            if not name.startswith(("Memcpy", "Memset")):
                name = name.split("(")[0].strip()[:60]   # drop signature
            c0, us0 = out.get(name, (0, 0.0))
            out[name] = (c0 + e.count, us0 + float(us))
    return out or None


def stage_breakdown(p, dev):
    """Where one full-size energy solve spends its wall time: the
    stages of solve_fast run one by one, then the device's busy time in
    one profiled solve_fast against its unprofiled wall.  The profile
    must show one burst kernel launch a burst of that solve and no
    kernel of the per-step design (primal_step, dual_step)."""
    from repro_torch.core import solver, verify
    from repro_torch.kernels import ops
    t = [time.perf_counter()]
    lp, idx = solver.build_routing_lp(p, "energy")
    t.append(time.perf_counter())
    res = solver.solve_lp(lp, device=dev)
    t.append(time.perf_counter())
    r = solver._assemble_fast_result(p, lp, idx, res)
    t.append(time.perf_counter())
    verify.check_schedule(p, r.schedule).assert_ok("stage breakdown")
    t.append(time.perf_counter())
    names = ("LP build (structure cached)", "solve_lp (pack + PDHG)",
             "decompose + pack + evaluate", "certificate")
    for name, a, b in zip(names, t, t[1:]):
        say(f"    stage {name}: {b - a:.3f} s")
    t0 = time.perf_counter()
    solver.solve_fast(p, "energy", device=dev)
    wall = time.perf_counter() - t0
    before = ops.PDHG_BURST_LAUNCHES
    busy = profile_device(lambda: solver.solve_fast(p, "energy",
                                                    device=dev))
    bursts = ops.PDHG_BURST_LAUNCHES - before
    require(busy is not None, "the profiler saw no device time, so it "
                              "cannot count the burst's launches")
    burst_kernels = sum(c for k, (c, _) in busy.items()
                        if "pdhg_burst_kernel" in k)
    per_step = [k for k in busy if "primal_step" in k or "dual_step" in k]
    say(f"    profiler: {bursts} bursts, {burst_kernels} launches of "
        f"pdhg_burst_kernel, kernels of the per-step design: {per_step}")
    require(bursts > 0 and burst_kernels == bursts and not per_step,
            f"profiled solve: {bursts} bursts, {burst_kernels} burst "
            f"kernels, per-step kernels {per_step}")
    busy_s = sum(us for _, us in busy.values()) * 1e-6
    say(f"    device busy {busy_s:.3f} s of a {wall:.3f} s solve_fast "
        f"(idle share {1.0 - busy_s / wall:.3f}); by kernel: "
        + ", ".join(f"{k} x{c} {us * 1e-3:.1f} ms"
                    for k, (c, us) in sorted(busy.items())))


def batch_stages() -> tuple:
    """The host stages of solve_fast_batch that stage_clock times, as
    (label, module, function); an indented label is part of the one
    above it."""
    from repro_torch.core import solver
    from repro_torch.kernels import ops, pdhg_spmv
    return (("LP builds", solver, "build_routing_lp"),
            ("block_stack", solver, "block_stack"),
            ("pack (_pack_ell)", solver, "_pack_ell"),
            ("  of it: ELL plans", pdhg_spmv, "ell_plan"),
            ("    of them: work lists", pdhg_spmv, "work_list"),
            ("work lists to the card", pdhg_spmv, "burst_work"),
            ("adaptive driver (bursts, a sync a chunk)", ops,
             "pdhg_adaptive"),
            ("per-instance residuals", solver, "_per_instance_residuals"),
            ("assemble (decompose + pack + evaluate)", solver,
             "_assemble_fast_result"))


@contextlib.contextmanager
def stage_clock(stages):
    """While the block runs, add each stage function's wall time, summed
    over its calls, to the dict it yields (label -> s)."""
    spent = {label: 0.0 for label, _, _ in stages}

    def clocked(label, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[label] += time.perf_counter() - t0
        return run

    with contextlib.ExitStack() as stack:
        for label, mod, name in stages:
            stack.enter_context(mock.patch.object(
                mod, name, clocked(label, getattr(mod, name))))
        yield spent


# ---------------------------------------------------------------------------
# phases 11-15: the bf16-storage burst, the batched path and the sweep
# ---------------------------------------------------------------------------

def on_bf16_grid(t) -> bool:
    """Every element of an fp32 tensor is a bf16 value (low 16 bits 0)."""
    import torch
    return bool(((t.contiguous().view(torch.int32) & 0xFFFF) == 0).all())


def compare_burst_bf16(label, op, args, iters, sms) -> float:
    """The bf16-storage kernel against its plain version on the same card
    inputs, and bitwise against its summation-order model and itself on
    one block an SM (check_kernel_order).  Every x and y element must lie
    on the bf16 grid (the fp32
    kernel's must not, or the check could not fail); after one iteration
    each element within one bf16 place of the plain one plus phase 3's
    fp32 tolerance (the two round one fp32 value computed in another sum
    order), and the kernel's residual within the fp32 tolerance of the
    plain residual of the kernel's own x.  After 500 iterations the
    difference is printed against the iterate scale.  Returns the
    largest absolute difference over (x, y, worst)."""
    import torch
    from repro_torch.kernels import ops, pdhg_spmv
    kw = dict(layout(op, args[0].device), iters=iters)
    k = ops.pdhg_burst(*args, **kw, precision="bf16")
    p = pdhg_spmv.pdhg_update_burst(args[12], args[13], *args[:12], **kw,
                                    precision="bf16")
    f = ops.pdhg_burst(*args, **kw)
    # the plain residual of the kernel's own final x
    _, _, w_own = pdhg_spmv.pdhg_update_burst(
        k[0], k[1], *args[:12], row_meta=op.rows.meta,
        col_meta=op.cols.meta, iters=0)
    torch.cuda.synchronize()
    check_kernel_order(label, op, args, iters, "bf16", k, sms)
    require(on_bf16_grid(k[0]) and on_bf16_grid(k[1]),
            f"{label}: a bf16 kernel output is off the bf16 grid")
    require(not (on_bf16_grid(f[0]) and on_bf16_grid(f[1])),
            f"{label}: the fp32 kernel's output lies on the bf16 grid, so "
            f"the grid check cannot fail")
    x_scale = float(p[0].abs().max())
    worst_err = 0.0
    for name, kv, pv in zip(("x", "y", "worst"), k, p):
        err = float((kv - pv).abs().max())
        scale = float(pv.abs().max())
        require(bool(torch.isfinite(kv).all()), f"{label}: {name} not finite")
        if iters == 1 and name != "worst":
            excess = float(((kv - pv).abs() / (RTOL_1 * max(scale, 1e-30)
                                               + BF16_PLACE * pv.abs()))
                           .max())
            say(f"  {label} bf16 iters=1 {name}: max|kernel-plain|="
                f"{err:.3e}, worst |kernel-plain|/limit {excess:.3f} "
                f"(limit {RTOL_1:g}*scale + 2^-7*|plain|, scale "
                f"{scale:.3e})")
            require(excess <= 1.0, f"{label}: bf16 {name} differs by more "
                                   f"than one bf16 place")
        else:
            say(f"  {label} bf16 iters={iters} {name}: max|kernel-plain|="
                f"{err:.3e} ({err / max(scale, x_scale, 1e-30):.3e} of the "
                f"iterate scale {max(scale, x_scale):.3e}; reported)")
        worst_err = max(worst_err, err)
    own = float((k[2] - w_own).abs().max())
    lim = RTOL_1 * max(float(w_own.abs().max()), 1e-30)
    require(own <= lim, f"{label}: bf16 residual vector differs from the "
                        f"plain residual of its x by {own:.3e} > {lim:.3e}")
    require(bool((k[0][op.n:] == 0).all() and (k[1][op.m:] == 0).all()),
            f"{label}: a padded slot moved")
    return worst_err


def stack_operands(lps, dev):
    """The operands solve_lp_batch hands to ops.pdhg_adaptive for a
    block-stacked batch: (stack, op, vecs, ell, inst_n, inst_m)."""
    import numpy as np
    import torch
    from repro_torch.core import solver
    bs = solver.block_stack(lps)
    g = bs.lp
    op, vecs, ell = solver._pack_ell(g.c, g.row, g.col, g.val, g.b, g.h,
                                     g.xmax, g.m_eq, dev)
    B = len(lps)
    inst_n = np.full(op.n_pad, B)
    inst_n[:g.n] = np.repeat(np.arange(B), np.diff(bs.n_off))
    inst_m = np.full(op.m_pad, B)
    inst_m[:g.m] = np.concatenate(
        [np.repeat(np.arange(B), np.diff(bs.eq_off)),
         np.repeat(np.arange(B), np.diff(bs.ub_off))])
    return (bs, op, vecs, ell, torch.from_numpy(inst_n).to(dev),
            torch.from_numpy(inst_m).to(dev))


def freeze_check(lps, tols, dev, chunk=500, max_chunks=3) -> None:
    """ops.pdhg_adaptive on a stack whose member 0 has tol=inf: it must
    report one chunk used while the others run all `max_chunks`, and
    member 0's iterates must equal one `chunk` burst of it alone,
    bitwise (a member's rows sum in the same order stacked or alone);
    `max_chunks` bursts of it alone must differ, so a driver that ignores
    freezing fails the check."""
    import torch
    from repro_torch.kernels import ops
    bs, op, vecs, ell, inst_n, inst_m = stack_operands(lps, dev)
    z = (torch.zeros(op.n_pad, device=dev), torch.zeros(op.m_pad, device=dev))
    t = torch.tensor([math.inf] + list(tols[1:]), dtype=torch.float32,
                     device=dev)
    x, y, res, used = ops.pdhg_adaptive(
        *vecs, *ell, *z, t, inst_n, inst_m, num_inst=len(lps),
        **layout(op, dev), chunk=chunk, max_chunks=max_chunks)
    used = used.cpu().tolist()
    say(f"    freeze: member 0 with tol=inf used {used[0]} chunk(s) of "
        f"{chunk}, the others {used[1:]}; residuals "
        f"{[f'{v:.3e}' for v in res.cpu().tolist()]}")
    require(used[0] == 1 and all(u == max_chunks for u in used[1:]),
            f"freeze: chunks used {used}")
    _, sop, svecs, sell, _, _ = stack_operands(lps[:1], dev)
    m_eq0, m0 = lps[0].m_eq, lps[0].m
    n0 = lps[0].n
    keep = (torch.zeros(sop.n_pad, dtype=torch.bool, device=dev),
            torch.zeros(sop.m_pad, dtype=torch.bool, device=dev))
    sz = (torch.zeros(sop.n_pad, device=dev),
          torch.zeros(sop.m_pad, device=dev))
    kw = layout(sop, dev)
    sx, sy, _ = ops.pdhg_burst(*svecs, *keep, *sell, *sz, iters=chunk, **kw)
    lx, _, _ = ops.pdhg_burst(*svecs, *keep, *sell, *sz,
                              iters=chunk * max_chunks, **kw)
    m_eq = int(bs.lp.m_eq)
    y0 = torch.cat([y[:m_eq0], y[m_eq:m_eq + m0 - m_eq0]])
    same = torch.equal(x[:n0], sx[:n0]) and torch.equal(y0, sy[:m0])
    moved = not torch.equal(lx[:n0], sx[:n0])
    say(f"    freeze: member 0's stacked iterates equal one {chunk}-"
        f"iteration burst of it alone bitwise: {same}; {chunk * max_chunks}"
        f" iterations alone differ from it: {moved}")
    require(same, "freeze: the frozen member's iterates are not those of "
                  "one chunk alone")
    require(moved, "freeze: the check cannot tell one chunk from "
                   f"{max_chunks}")


def sweep_rows(path) -> dict:
    """results.csv rows of the healthy fast path, keyed (topo, objective,
    pattern, seed)."""
    with open(path, newline="") as fh:
        return {(r["topo"], r["objective"], r["pattern"], int(r["seed"])): r
                for r in csv.DictReader(fh)
                if r["failure"] == "none" and r["policy"] == "lp"
                and r["arrivals"] == "none"
                and r["placement_search"] == "none"}


def rel_diff(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def in_kernel_order():
    """Route the burst's plain version (the CPU path of ops.pdhg_burst) to
    the kernel's summation order, pdhg_update_burst(order="kernel")."""
    import functools
    from repro_torch.kernels import pdhg_spmv
    return mock.patch.object(pdhg_spmv, "pdhg_update_burst",
                             functools.partial(pdhg_spmv.pdhg_update_burst,
                                               order="kernel"))


def row_differs(rec, row) -> list[str]:
    """The columns, solve_s aside, in which a sweep record and a
    results.csv row differ as written."""
    return [col for col, val in dataclasses.asdict(rec).items()
            if col != "solve_s" and str("" if val is None else val) != row[col]]


def check_order_sensitive(key, card_row, committed_row) -> None:
    """Re-solve one sweep row on the host CPU with the plain version, once
    summing in the kernel's order and once in its own: the first must
    give the card's row bitwise (every column but solve_s; a member of the
    card's 8-seed stack sums its rows as it does alone), the second the
    committed numbers within SWEEP_RTOL."""
    from repro_torch.sweep import runner
    topo, obj, pat, seed = key
    spec = runner.SweepSpec(topos=(topo,), objectives=(obj,),
                            patterns=(pat,), seeds=(seed,), device="cpu")
    with in_kernel_order():
        (kernel_order,), _ = runner.run_sweep(spec)
    (own_order,), _ = runner.run_sweep(spec)
    bad = row_differs(kernel_order, card_row)
    require(not bad, f"{key}: the kernel-order CPU solve differs from the "
                     f"card in {bad}")
    d = max(rel_diff(getattr(own_order, c), float(committed_row[c]))
            for c in ("energy_j", "completion_s"))
    say(f"    {key}: the plain version in the kernel's summation order "
        f"reproduces the card's row bitwise (E={kernel_order.energy_j}); in "
        f"its own order E={own_order.energy_j}, {d:.3e} from the committed "
        f"row")
    require(d <= SWEEP_RTOL, f"{key}: the CPU solve misses the committed "
                             f"row by {d:.3e}")


# ---------------------------------------------------------------------------
# phases 8-10: the attention kernel and the serving path
# ---------------------------------------------------------------------------

def fa_inputs(seed, B, S, H, Hkv, hd, dtype, dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((B, S, H, hd), (B, S, Hkv, hd),
                               (B, S, Hkv, hd)))


def fa_plain(q, k, v, window, cap, causal=True):
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    softcap=cap,
                                    scale=1.0 / q.shape[-1] ** 0.5)


def fa_p_rounded_once(q, k, v, window, cap):
    """A wrong attention, the checks' second negative control: the plain
    version with p rounded once to bf16 in p.v, the rounding the bf16
    kernel avoids by splitting p into hi + lo."""
    from repro_torch.kernels import flash_attention as fa
    return fa.flash_attention_bf16_model(q, k, v, causal=True, window=window,
                                         softcap=cap,
                                         scale=1.0 / q.shape[-1] ** 0.5,
                                         split=False)


def fa_drop_last_tile(q, k, v, window, cap):
    """A wrong attention, the checks' negative control: the plain version
    with the last kv tile's keys dropped, so the last KV_TILE query rows
    miss their own tile, the fault of a tile skip that is off by one."""
    T = k.shape[1] - KV_TILE
    return fa_plain(q, k[:, :T], v[:, :T], window, cap)


def fa_excess(got, want) -> float:
    """max over elements of |got - want| / (atol + rtol * |want|), with
    FA_TOL of want's dtype: at most 1 when got is within tolerance."""
    atol, rtol = FA_TOL[str(want.dtype).split(".")[-1]]
    want = want.float()
    return float(((got.float() - want).abs() / (atol + rtol * want.abs()))
                 .max())


def compare_attention(label, q, k, v, window, cap, causal) -> float:
    """The kernel against its plain version on the same card inputs, and
    two launches bitwise equal; returns max |kernel - plain|."""
    import torch
    from repro_torch.kernels import ops
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap)
    again = ops.flash_attention(q, k, v, causal=causal, window=window,
                                softcap=cap)
    want = fa_plain(q, k, v, window, cap, causal)
    torch.cuda.synchronize()
    atol, rtol = FA_TOL[str(q.dtype).split(".")[-1]]
    err = float((out.float() - want.float()).abs().max())
    excess = fa_excess(out, want)
    say(f"    {label:24s} {str(q.dtype):15s} max|kernel-plain|={err:.3e} "
        f"worst |kernel-plain|/limit {excess:.3f} (limit {atol:g} + "
        f"{rtol:.4g}*|plain|)")
    require(bool(torch.isfinite(out).all()), f"{label}: output not finite")
    require(excess <= 1.0, f"{label}: kernel differs from plain by {err:.3e}")
    require(torch.equal(out, again), f"{label}: two launches differ")
    return err


def ptxas_templates(log: str) -> list[str]:
    """One line per compiled kernel template from nvcc's -Xptxas -v log:
    its name and template arguments, registers, and spill bytes."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            t = re.search(r"(flash_fwd_[a-z]+)I((?:Li\d+E)+)E", m.group(1))
            name = (f"{t.group(1)}<" + ", ".join(
                re.findall(r"Li(\d+)E", t.group(2))) + ">"
                if t else m.group(1))
            spills = "spills not reported"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spills}")
            name = None
    return out


def attention_bound(B, S, H, Hkv, hd, window, itemsize):
    """Least time of one causal attention launch: 4*hd flop for each
    unmasked (query, key) pair (q.k and p.v) at the bf16 tensor-core
    peak, against q, k, v read once and the output written once at the
    HBM rate.  Returns (ms, bound_by, bytes, flop)."""
    q_idx = range(S)
    pairs = sum(min(i + 1, window) if window else i + 1 for i in q_idx)
    flop = 4 * hd * B * H * pairs
    nbytes = itemsize * hd * B * (2 * S * H + 2 * S * Hkv)
    t_ops = flop / BF16_OPS_S * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else
            "bytes", nbytes, flop)


def attention_patch(attn):
    """Route the model's kernel path to `attn(q, k, v, window, softcap)`:
    the plain version is the reference for the serving prefill on the
    card, fa_drop_last_tile the checks' negative control."""
    from repro_torch.kernels import ops

    def call(q, k, v, *, causal=True, window=None, softcap=0.0):
        return attn(q, k, v, int(window or 0), softcap)
    return mock.patch.object(ops, "flash_attention", call)


def report_logits(label, got, want) -> None:
    """Print how far the prefill's last-token logits drift when the
    attention is the plain version: finite logits are required, the
    drift is reported (see compare_sublayers for the bound)."""
    import torch
    require(bool(torch.isfinite(got).all()), f"{label}: logits not finite")
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max()) / scale
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    say(f"    {label}, whole model, kernel vs plain attention: logits "
        f"scale {scale:.4f}, max|kernel-plain|/scale {err:.3e}, argmax "
        f"agrees on {agree:.3f} of rows (reported, not bounded)")


def scan_plain(a, b, h0=None):
    """The scan kernel's plain version (kernels.rglru_scan)."""
    from repro_torch.kernels.rglru_scan import rglru_scan_plain
    return rglru_scan_plain(a, b, h0)


def scan_drop_last_step(a, b, h0=None):
    """A wrong scan, the checks' negative control: the last step is never
    taken (h at the last position and h_last repeat the step before)."""
    import torch
    h, h_last = scan_plain(a[:, :-1], b[:, :-1], h0)
    return torch.cat([h, h[:, -1:]], dim=1), h_last


def scan_ignore_h0(a, b, h0=None):
    """A wrong scan, the checks' other negative control: h0 is dropped."""
    return scan_plain(a, b, None)


def scan_fused(a, b, h0=None):
    """A wrong scan, the checks' third negative control: each step rounds
    a*h + b once, as a fused multiply-add does (computed in float64 from
    the fp32 operands, where the product is exact, then rounded to fp32)."""
    import torch
    B, S, R = a.shape
    h = (torch.zeros((B, R), dtype=a.dtype, device=a.device) if h0 is None
         else h0)
    out = torch.empty_like(a)
    for t in range(S):
        h = (a[:, t].double() * h.double() + b[:, t].double()).float()
        out[:, t] = h
    return out, h.clone()


def scan_misaligned(t):
    """A contiguous copy of `t` that starts 4 bytes past a 16-byte
    boundary."""
    import torch
    flat = torch.empty(t.numel() + 3, dtype=t.dtype, device=t.device)
    skip = (4 - flat.data_ptr()) % 16 // 4
    view = flat[skip:skip + t.numel()].view(t.shape)
    view.copy_(t)
    require(view.data_ptr() % 16 == 4, "misaligned view not 4 B past 16")
    return view


def scan_equal(got, want) -> bool:
    """h and h_last bitwise equal."""
    import torch
    return all(torch.equal(g, w) for g, w in zip(got, want))


def scan_inputs(seed, B, S, R, dev):
    """a and b as the recurrent layer makes them: a = exp(log_a) in (0, 1)
    with log_a = -8 softplus(lam) sigmoid(z), b = sqrt(1 - a^2) n; z, n,
    lam and h0 standard normal."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    lam = torch.randn(R, generator=g, device=dev)
    z, n = (torch.randn((B, S, R), generator=g, device=dev)
            for _ in range(2))
    log_a = -8.0 * torch.nn.functional.softplus(lam) * torch.sigmoid(z)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * n
    h0 = torch.randn((B, R), generator=g, device=dev)
    return torch.exp(log_a), b, h0


def compare_scan(label, a, b, h0) -> float:
    """The scan kernel against its plain version on the same card inputs:
    h and h_last bitwise equal, and two launches bitwise equal.  Returns
    max |kernel - plain| (0 when it passes)."""
    import torch
    from repro_torch.kernels import ops
    out = ops.rglru(a, b, h0)
    again = ops.rglru(a, b, h0)
    want = scan_plain(a, b, h0)
    torch.cuda.synchronize()
    err = max(float((o - w).abs().max()) for o, w in zip(out, want))
    same = scan_equal(out, want)
    say(f"    {label:34s} max|kernel-plain|={err:.3e} bitwise {same}")
    require(all(bool(torch.isfinite(o).all()) for o in out),
            f"{label}: scan output not finite")
    require(same, f"{label}: scan kernel differs from plain by {err:.3e}")
    require(scan_equal(out, again), f"{label}: two scan launches differ")
    return err


def scan_bound(B, S, R) -> tuple[float, str, int, int]:
    """Least time of one scan on this card: a and b read once, h written
    once, h0 read and h_last written once, against 2 fp32 ops a step.
    Returns (ms, bound_by, bytes, ops)."""
    nbytes = (3 * B * S * R + 2 * B * R) * 4
    nops = 2 * B * S * R
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = nops / FP32_OPS_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, nops)


def mixer_patch(block, fn):
    """Route a block's kernel path to `fn`: the scan (ops.rglru, called
    as fn(a, b, h0)) in a recurrent block, else the attention (called as
    fn(q, k, v, window, softcap), see attention_patch)."""
    from repro_torch.kernels import ops
    if block.kind == "rglru":
        return mock.patch.object(ops, "rglru", fn)
    return attention_patch(fn)


def sublayer_excess(block, x, pos, broken=None) -> float:
    """One layer's first sublayer (attention: projections, attention, wo;
    recurrent: projections, conv, gates, scan, gate, w_out) on
    rms_norm(x), through its kernel (or through `broken`), against the
    same sublayer through the plain version.  The two attention outputs
    differ by a rare last bf16 place, which wo spreads over a row, and
    each output is rounded once more to bf16 (the scan's two are
    bitwise equal); so each element is held within one bf16 place of
    itself plus one of its row's rms.  Returns max |got - want| / that
    limit."""
    import contextlib
    from repro_torch.models.common import rms_norm
    h = rms_norm(x, block.ln1, block.eps)
    with mixer_patch(block, broken) if broken else contextlib.nullcontext():
        got, _ = block.mixer(h, pos, mode="train", impl="kernel")
    plain = scan_plain if block.kind == "rglru" else fa_plain
    with mixer_patch(block, plain):
        want, _ = block.mixer(h, pos, mode="train", impl="kernel")
    want = want.float()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    return float(((got.float() - want).abs()
                  / (BF16_PLACE * (want.abs() + rms))).max())


def compare_sublayers(label, model, toks) -> float:
    """sublayer_excess in every layer, on the hidden state of the kernel
    path; requires it at most 1 everywhere, and above 1 in the first layer
    of each kind when its kernel is replaced by a broken one (an attention
    that drops the last kv tile, a scan that drops the last step), so the
    check can fail.  Returns the worst ratio."""
    import torch
    from repro_torch.models import transformer
    x = transformer._embed(model, toks)
    pos = torch.arange(toks.shape[1], device=toks.device)[None, :]
    worst, broken, count = {}, {}, {}
    with torch.no_grad():
        for i, block in enumerate(model.blocks):
            kind = "rglru" if block.kind == "rglru" else "attention"
            count[kind] = count.get(kind, 0) + 1
            if kind not in broken:
                broken[kind] = (i, sublayer_excess(
                    block, x, pos, scan_drop_last_step if kind == "rglru"
                    else fa_drop_last_tile))
            worst[kind] = max(worst.get(kind, 0.0),
                              sublayer_excess(block, x, pos))
            x, _ = block(x, pos, mode="train", impl="kernel")
            require(bool(torch.isfinite(x).all()),
                    f"{label} layer {i}: not finite")
    for kind in worst:
        i, bad = broken[kind]
        say(f"    {label}, {kind} sublayer in each layer, kernel vs plain on "
            f"the same input: worst |kernel-plain|/limit {worst[kind]:.3f} "
            f"over {count[kind]} layers (limit {BF16_PLACE:g}*(|plain| "
            f"+ row rms)); with the "
            f"{'last step' if kind == 'rglru' else 'last kv tile'} dropped, "
            f"layer {i} reads {bad:.3f}")
        require(worst[kind] <= 1.0, f"{label}: an {kind} sublayer differs, "
                                    f"{worst[kind]:.3f} of its limit")
        require(bad > 1.0, f"{label}: the {kind} sublayer check passes a "
                           f"broken kernel ({bad:.3f})")
    return max(worst.values())


def check_ring(model, toks, nxt) -> None:
    """The windowed layer's ring cache on the card: after a prefill of
    S > window tokens, slot p % window holds the key and value of
    position p for the last `window` positions; one decode step then
    overwrites exactly slot S % window.  Checked bitwise on layer 0,
    whose keys depend on the tokens alone."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.common import rms_norm
    from repro_torch.runtime import steps
    cfg = model.cfg
    S, W = toks.shape[1], cfg.window
    block = model.blocks[0]
    with torch.no_grad():
        _, caches = steps.make_prefill_step(cfg, impl="kernel", max_len=S + 8)(
            model, {"tokens": toks})
        h = rms_norm(transformer._embed(model, toks), block.ln1, cfg.rms_eps)
        _, k_all, v_all = block.attn._qkv(
            h, torch.arange(S, device=toks.device)[None, :])
        pos = torch.arange(S - W, S, device=toks.device)
        ring = caches[0]
        require(torch.equal(ring["k"][:, pos % W], k_all[:, pos]) and
                torch.equal(ring["v"][:, pos % W], v_all[:, pos]),
                "ring cache: prefill keys are not at slot p % window")
        before = ring["k"].clone()
        _, caches = steps.make_decode_step(cfg, impl="kernel")(
            model, caches, nxt, S)
        h1 = rms_norm(transformer._embed(model, nxt), block.ln1, cfg.rms_eps)
        _, k1, _ = block.attn._qkv(
            h1, torch.full((1, 1), S, device=toks.device))
        slot = S % W
        changed = (caches[0]["k"] != before).any(dim=(0, 2, 3))
        require(torch.equal(caches[0]["k"][:, slot], k1[:, 0]) and
                changed.nonzero().flatten().tolist() in ([slot], []),
                "ring cache: decode did not write exactly slot S % window")
    say(f"    ring cache, layer 0: slots p % {W} hold positions "
        f"{S - W}..{S - 1} bitwise; decode at {S} wrote slot {slot} only")


def report_busy(label, fn, wall) -> None:
    """Device busy time of one call of `fn` by torch.profiler, against the
    call's unprofiled host wall `wall` (s), and the largest kernels."""
    busy = profile_device(fn)
    if busy is None:
        say(f"    {label}: device busy share not measured (the profiler "
            f"saw no device time)")
        return
    busy_s = sum(us for _, us in busy.values()) * 1e-6
    launches = sum(c for c, _ in busy.values())
    ours = []
    for what, key in (("attention kernel", "flash_fwd"),
                      ("scan kernel", "rglru_scan")):
        t = sum(us for n, (_, us) in busy.items() if key in n) * 1e-6
        if t > 0 or key == "flash_fwd":
            ours.append(f"{what} {t * 1e3:.3f} ms ({t / busy_s:.3f} of busy)")
    say(f"    {label}: device busy {busy_s * 1e3:.3f} ms of {wall * 1e3:.3f} "
        f"ms wall (idle share {1.0 - busy_s / wall:.3f}), {launches} "
        f"kernels; " + "; ".join(ours))
    for name, (count, us) in sorted(busy.items(),
                                    key=lambda kv: -kv[1][1])[:6]:
        say(f"    profiler: {name} x{count}: {us * 1e-3:.3f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep-out", default="",
                    help="directory for phase 14's results.csv and "
                         "results.md (default: a new temporary directory)")
    sweep_out = ap.parse_args(argv).sweep_out
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import solver, verify
    from repro_torch.kernels import build, ops, pdhg_spmv
    from repro_torch.launch import serve
    from repro_torch.runtime import steps

    t_start = time.perf_counter()
    # -- phase 1: card -----------------------------------------------------
    card = card_line()
    say(f"[1] card: {card}")
    say(f"    torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices "
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"    allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda", 0)

    # -- phase 2: build (the three kernels, one nvcc each, started together)
    sources = ("pdhg_burst.cu", "flash_attention.cu", "rglru_scan.cu")
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.load, sources))
    info = build.BUILD_INFO["pdhg_burst.cu"]
    say(f"[2] built pdhg_burst.cu in {info['seconds']:.3f} s -> "
        f"{pathlib.Path(info['library']).name}")
    for line in info["log"].splitlines():
        if "Compiling entry" in line:
            # the kernel's two templates: fp32 and bf16-storage iterates
            kind = "bf16" if "bfloat16" in line else "fp32"
            say(f"    ptxas [{kind}]: {line.strip()}")
        elif "registers" in line or "spill" in line or "stack" in line:
            say(f"    ptxas: {line.strip()}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grids = {prec: ops.burst_max_blocks(prec, dev) for prec in ("fp32",
                                                               "bf16")}
    say(f"    burst grid: {grids['fp32']} blocks (fp32), {grids['bf16']} "
        f"(bf16) of 512 threads fit at once on {sms} SMs")
    require(min(grids.values()) >= sms, f"burst grid {grids}")

    # -- phase 3: kernel vs plain version ----------------------------------
    say("[3] kernel vs plain version on the card")
    errs, torch_order_differs = [], []
    for seed, (m, n, m_eq) in enumerate([(300, 250, 120), (1025, 777, 600)]):
        op, args = random_burst_args(seed, m, n, m_eq, dev)
        for iters in (1, 500):
            err, differs = compare_burst(f"random#{seed} m={m} n={n}", op,
                                         args, iters, sms)
            errs.append(err)
            torch_order_differs.append(differs)
    before = ops.PDHG_BURST_LAUNCHES
    try:
        ops.pdhg_burst(*args, **layout(op, dev), iters=1,
                       _blocks=grids["fp32"] + 1)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    say(f"    a launch on {grids['fp32'] + 1} blocks (one more than fit) "
        f"raises: {refused}")
    require(refused is not None and ops.PDHG_BURST_LAUNCHES == before,
            "a cooperative launch on more blocks than fit did not raise")
    t0 = time.perf_counter()
    p_full = problem(*FULL)
    t1 = time.perf_counter()
    lp_full, _ = solver.build_routing_lp(p_full, "energy")
    say(f"    full-size LP (fat-tree k=16, energy): n={lp_full.n} "
        f"m={lp_full.m} (eq {lp_full.m_eq}) nnz={len(lp_full.val)}; "
        f"problem {t1 - t0:.3f} s, LP build (cold) "
        f"{time.perf_counter() - t1:.3f} s")
    op_full, args_full = lp_burst_args(lp_full, dev)
    say(f"    ELL: n_pad={op_full.n_pad} m_pad={op_full.m_pad} row slots "
        f"{len(op_full.rows.idx)} col slots {len(op_full.cols.idx)}; "
        f"row widths {min(op_full.rows.widths)}..{max(op_full.rows.widths)}"
        f", col widths {min(op_full.cols.widths)}.."
        f"{max(op_full.cols.widths)}")
    for iters in (1, 500):
        err, differs = compare_burst("fat-tree-k16", op_full, args_full,
                                     iters, sms)
        errs.append(err)
        torch_order_differs.append(differs)
    max_abs_err = max(errs)
    say(f"    the plain version (torch's sum order) differs from the kernel "
        f"bitwise in {sum(torch_order_differs)} of "
        f"{len(torch_order_differs)} cases, so the bitwise check can fail")
    require(any(torch_order_differs), "the bitwise check cannot fail")

    # -- phase 4: main path on the paper topologies ------------------------
    say("[4] main path: six paper topologies x {energy, time}")
    golden = json.loads(GOLDEN.read_text())
    ops.PDHG_BURST_LAUNCHES = 0
    paper_launches = 0
    paper_fp32 = {}           # (topo, objective) -> metrics, for phase 12
    for name in PAPER_TOPOS:
        p = problem(name, {}, GOLDEN_PATTERN, 2)
        for obj in OBJECTIVES:
            before = ops.PDHG_BURST_LAUNCHES
            t0 = time.perf_counter()
            r = solver.solve_fast(p, obj, device="cuda")
            wall = time.perf_counter() - t0
            paper_launches += ops.PDHG_BURST_LAUNCHES - before
            cert = verify.check_schedule(p, r.schedule)
            cert.assert_ok(f"{name}/{obj} on the card")
            got = metrics_of(r)
            paper_fp32[name, obj] = got
            cpu = metrics_of(solver.solve_fast(p, obj, device="cpu"))
            require(close(got, cpu, METRIC_RTOL),
                    f"{name}/{obj}: card {got} vs cpu {cpu}")
            pin = ""
            if name in GOLDEN_TOPOS:
                want = golden[f"{name}/min-{obj}/seed0"]
                require(close(got, {k: want[k] for k in got}, METRIC_RTOL),
                        f"{name}/{obj}: card {got} vs golden {want}")
                pin = " golden=ok"
            say(f"    {name:10s} {obj:6s} E={got['energy_j']:.6f} J "
                f"M={got['completion_s']:.6f} s iters={r.iterations} "
                f"wall={wall:.3f} s cert=ok cpu=ok{pin}")
    paper_read = ops.PDHG_BURST_LAUNCHES
    say(f"    pdhg_burst launches on this phase: {paper_read}")
    require(paper_read > 0 and paper_read == paper_launches,
            "phase 4 did not go through the CUDA kernel")

    # -- phase 5: main path at full size -----------------------------------
    say("[5] main path at full size: fat-tree k=16, 20x12 shuffle, "
        "120 Gbit")
    ops.PDHG_BURST_LAUNCHES = 0
    full_iters = 0
    full_fp32 = {}
    for obj in OBJECTIVES:
        runs = []
        for rep in range(2):
            t0 = time.perf_counter()
            r = solver.solve_fast(p_full, obj, device="cuda")
            wall = time.perf_counter() - t0
            t1 = time.perf_counter()
            verify.check_schedule(p_full, r.schedule).assert_ok(
                f"fat-tree-k16/{obj} run {rep}")
            cert_s = time.perf_counter() - t1
            m = r.metrics
            require(np.isfinite(r.schedule).all() and r.schedule.shape ==
                    p_full.shape_x, "full-size schedule shape/finite")
            say(f"    {obj:6s} run {rep}: wall={wall:.3f} s "
                f"iters={r.iterations} restarts="
                f"{restarts(r.iterations, 4000)} "
                f"primal={r.lp_primal_residual:.3e} "
                f"E={m.energy_j:.6f} J M={m.completion_s:.6f} s "
                f"T={p_full.n_slots} cert=ok ({cert_s:.3f} s)")
            runs.append(r)
            full_iters += r.iterations
        full_fp32[obj] = metrics_of(r)         # for phase 12
        a, b = runs
        require(np.array_equal(a.lp_x, b.lp_x)
                and np.array_equal(a.lp_y, b.lp_y)
                and np.array_equal(a.schedule, b.schedule),
                f"fat-tree-k16/{obj}: two runs differ")
        say(f"    {obj:6s} two runs bitwise identical (lp_x, lp_y, "
            f"schedule)")
    full_launches = ops.PDHG_BURST_LAUNCHES
    say(f"    pdhg_burst launches on this phase: {full_launches} bursts, "
        f"each one cooperative CUDA launch ({full_iters} PDHG iterations)")
    require(full_launches > 0, "phase 5 did not go through the CUDA kernel")
    stage_breakdown(p_full, dev)

    # -- phase 6: times ----------------------------------------------------
    say(f"[6] times per PDHG iteration at the full-size shapes ({card})")
    kw = layout(op_full, dev)
    n_k, n_p = 2000, 20
    ms = sorted(time_events(lambda: ops.pdhg_burst(*args_full, iters=n_k,
                                                   **kw), 1) / n_k
                for _ in range(3))[1]
    ms_sm = sorted(time_events(lambda: ops.pdhg_burst(
        *args_full, iters=n_k, _blocks=sms, **kw), 1) / n_k
        for _ in range(3))[1]
    plain_ms = time_events(lambda: pdhg_spmv.pdhg_update_burst(
        args_full[12], args_full[13], *args_full[:12], iters=n_p, **kw),
        1) / n_p
    # yardstick: one PyTorch CSR mat-vec each way (cuSPARSE), the sparse
    # work of one iteration; the port never calls it
    with warnings.catch_warnings():
        # torch warns that CSR support is in beta
        warnings.simplefilter("ignore", UserWarning)
        K = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([lp_full.row, lp_full.col])),
            torch.from_numpy(lp_full.val.astype(np.float32)),
            (lp_full.m, lp_full.n), check_invariants=True).coalesce()
        Kc = K.to_sparse_csr().to(dev)
        KTc = K.t().coalesce().to_sparse_csr().to(dev)
    xv = torch.rand(lp_full.n, 1, device=dev)
    yv = torch.rand(lp_full.m, 1, device=dev)
    library_ms = time_events(lambda: (Kc @ xv, KTc @ yv), 200)
    bound_ms, bound_by, nbytes, nops = burst_bound(op_full, len(lp_full.val))
    say(f"    kernel  {ms:.6f} ms/iter (burst of {n_k}, median of 3; "
        f"{grids['fp32']} blocks)")
    say(f"    kernel  {ms_sm:.6f} ms/iter on {sms} blocks (one an SM)")
    say(f"    plain   {plain_ms:.6f} ms/iter (burst of {n_p})")
    say(f"    library {library_ms:.6f} ms per K.x + K^T.y pair "
        f"(torch CSR matmul)")
    say(f"    bound   {bound_ms:.6f} ms/iter ({bound_by}: {nbytes} B at "
        f"3.35 TB/s, {nops} fp32 ops at 67 TFLOP/s; the real entries)")
    pad_ms, pad_by, pad_bytes, _ = burst_bound(op_full, len(lp_full.val),
                                               padded=True)
    say(f"    bound   {pad_ms:.6f} ms/iter counting every padded slot "
        f"({pad_by}: {pad_bytes} B), for comparison with earlier bounds")
    per_launch = profile_device(lambda: ops.pdhg_burst(
        *args_full, iters=200, **kw))
    if per_launch is None:
        say("    per-kernel device time: not measured (the profiler saw no "
            "device time)")
    for name, (count, us) in sorted((per_launch or {}).items()):
        say(f"    profiler: {name} x{count}: {us / count:.3f} us a launch")
    say(f"    phases 1-6 took {time.perf_counter() - t_start:.1f} s")

    # -- phase 7: the attention kernel's build -----------------------------
    fa_info = build.BUILD_INFO["flash_attention.cu"]
    say(f"[7] built flash_attention.cu in {fa_info['seconds']:.3f} s "
        f"(started with the others in phase 2) -> "
        f"{pathlib.Path(fa_info['library']).name}")
    templates = ptxas_templates(fa_info["log"])
    for line in templates:
        say(f"    ptxas: {line}")
    require(len(templates) == 10 or not fa_info["log"],
            f"expected 10 attention templates (5 bf16, 5 fp32) in the "
            f"ptxas log, found {len(templates)}")

    # -- phase 8: attention kernel vs plain version ------------------------
    say("[8] attention kernel vs plain version on the card")
    fa_errs = []
    for seed, (name, B, S, H, Hkv, hd, window, cap, causal) in enumerate(
            FA_CASES):
        for dt in FA_DTYPES:
            q, k, v = fa_inputs(seed, B, S, H, Hkv, hd, getattr(torch, dt),
                                dev)
            fa_errs.append(compare_attention(
                f"{name} S={S} H={H}/{Hkv} hd={hd} w={window} cap={cap:g}"
                f"{'' if causal else ' non-causal'}",
                q, k, v, window, cap, causal))
            if name == "phi4-serve" and dt == "bfloat16":
                want = fa_plain(q, k, v, window, cap)
                for what, wrong in (("the last kv tile dropped",
                                     fa_drop_last_tile),
                                    ("p rounded once to bf16 in p.v",
                                     fa_p_rounded_once)):
                    broken = fa_excess(wrong(q, k, v, window, cap), want)
                    say(f"    negative control: {what} reads {broken:.3f} "
                        f"of the limit")
                    require(broken > 1.0, f"the attention check passes an "
                                          f"attention with {what}")
                del want
            del q, k, v
    fa_max_err = max(fa_errs)

    # -- phase 9: serving path at full width --------------------------------
    say("[9] serving path: phi4-mini-3.8b at full width, batch 4, prompt "
        "2048, 32 tokens, impl=kernel")
    cfg = configs.get("phi4-mini-3.8b")
    served = []
    for rep in range(2):
        ops.PDHG_BURST_LAUNCHES = 0
        ops.FLASH_ATTENTION_LAUNCHES = 0
        t0 = time.perf_counter()
        served.append(serve.main(SERVE_ARGS))
        wall = time.perf_counter() - t0
        serve_launches = ops.FLASH_ATTENTION_LAUNCHES
        say(f"    run {rep}: serve.main wall {wall:.3f} s (weights drawn on "
            f"the card included); flash_attention launches "
            f"{serve_launches}, pdhg_burst launches "
            f"{ops.PDHG_BURST_LAUNCHES}")
        require(serve_launches == cfg.n_layers,
                f"serving prefill launched the attention kernel "
                f"{serve_launches} times, expected {cfg.n_layers}")
    require(served[0].shape == (4, 32), f"tokens {served[0].shape}")
    require(np.array_equal(served[0], served[1]), "two serving runs differ")
    say("    two runs: identical tokens")
    model, toks = serve.build(cfg, 4, 2048, 0, dev)
    prefill = steps.make_prefill_step(cfg, impl="kernel", max_len=2048 + 32)
    logits_k, _ = prefill(model, {"tokens": toks})
    with attention_patch(fa_plain):
        logits_p, _ = prefill(model, {"tokens": toks})
    torch.cuda.synchronize()
    require(np.array_equal(logits_k[:, -1].argmax(-1).cpu().numpy(),
                           served[0][:, 0]),
            "serve.main's first tokens are not this prefill's argmax")
    report_logits("phi4 prefill", logits_k, logits_p)
    del logits_k, logits_p
    compare_sublayers("phi4 prefill", model, toks)

    say("    h2o-danube-3-4b at full width, 4 layers (window 4096, hd 120), "
        "batch 1, prompt 6144, 8 tokens")
    dcfg = dataclasses.replace(configs.get("h2o-danube-3-4b"), n_layers=4)
    dmodel, dtoks = serve.build(dcfg, 1, 6144, 0, dev)
    ops.FLASH_ATTENTION_LAUNCHES = 0
    g = serve.generate(dmodel, dtoks, 8, impl="kernel")
    dl = ops.FLASH_ATTENTION_LAUNCHES
    cache0 = g.caches[0]
    say(f"    prefill {g.prefill_s * 1e3:.1f} ms, 7 decode steps "
        f"{g.decode_s * 1e3:.1f} ms; flash_attention launches {dl}; "
        f"ring cache {tuple(cache0['k'].shape)} len {cache0['len']}; "
        f"tokens {g.tokens[0].tolist()}")
    require(dl == dcfg.n_layers, f"danube prefill launched {dl} times")
    require(cache0["k"].shape[1] == dcfg.window and
            cache0["len"] == 6144 + 7, "danube ring cache")
    require(bool(torch.isfinite(g.prefill_logits).all()),
            "danube logits not finite")
    compare_sublayers("danube prefill", dmodel, dtoks)
    check_ring(dmodel, dtoks, g.tokens[:, :1])
    del dmodel, g

    # -- phase 10: times at the serving shapes -----------------------------
    say(f"[10] times at the serving shapes ({card})")
    q, k, v = fa_inputs(99, 4, 2048, 24, 8, 128, torch.bfloat16, dev)
    fa_ms = sorted(time_events(lambda: ops.flash_attention(q, k, v), 10)
                   for _ in range(3))[1]
    fa_plain_ms = time_events(lambda: fa_plain(q, k, v, 0, 0.0), 3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fa_lib_ms = time_events(lambda: sdpa(qt, kt, vt, is_causal=True,
                                         enable_gqa=True), 10)
    fa_bound_ms, fa_bound_by, fa_bytes, fa_flop = attention_bound(
        4, 2048, 24, 8, 128, 0, 2)
    del q, k, v, qt, kt, vt
    say(f"    attention kernel {fa_ms:.6f} ms a launch (q (4, 2048, 24, 128),"
        f" k/v (4, 2048, 8, 128), bf16, causal; median of 3 runs of 10)")
    say(f"    plain version    {fa_plain_ms:.6f} ms")
    say(f"    library          {fa_lib_ms:.6f} ms (torch "
        f"scaled_dot_product_attention, is_causal, enable_gqa, (B,H,S,hd))")
    say(f"    bound            {fa_bound_ms:.6f} ms ({fa_bound_by}: "
        f"{fa_flop} flop at 989 TFLOP/s bf16, {fa_bytes} B at 3.35 TB/s)")
    say(f"    useful work      {fa_flop / fa_ms * 1e-9:.3f} TFLOP/s (the "
        f"bound's flop over the kernel's time); the kernel takes "
        f"{fa_ms / fa_bound_ms:.3f}x its bound and {fa_ms / fa_lib_ms:.3f}x "
        f"the library's time")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(model, {"tokens": toks})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prefill_wall = sorted(walls)[1]
    g = serve.generate(model, toks, 32, impl="kernel")
    say(f"    phi4 prefill wall {prefill_wall * 1e3:.3f} ms (median of 3); "
        f"decode {g.decode_s / 31 * 1e3:.3f} ms a token (31 steps, batch 4)")
    report_busy("prefill", lambda: prefill(model, {"tokens": toks}),
                prefill_wall)
    decode = steps.make_decode_step(cfg, impl="kernel")
    tok = g.tokens[:, -1:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode(model, g.caches, tok, 2048 + 31)
    torch.cuda.synchronize()
    report_busy("decode step", lambda: decode(model, g.caches, tok, 2048 + 31),
                time.perf_counter() - t0)
    say(f"    peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; total {time.perf_counter() - t_start:.1f} s")
    del model, toks, g, tok           # phi4's weights and caches
    torch.cuda.empty_cache()

    # -- phase 11: the bf16-storage burst vs its plain version -------------
    say("[11] bf16-storage kernel (pdhg_burst_bf16) vs its plain version "
        "on the card")
    bf16_errs = []
    for seed, (m, n, m_eq) in enumerate([(300, 250, 120), (1025, 777, 600)]):
        op, args = random_burst_args(seed, m, n, m_eq, dev)
        for iters in (1, 500):
            bf16_errs.append(compare_burst_bf16(
                f"random#{seed} m={m} n={n}", op, args, iters, sms))
    for iters in (1, 500):
        bf16_errs.append(compare_burst_bf16("fat-tree-k16", op_full,
                                            args_full, iters, sms))
    bf16_max_err = max(bf16_errs)

    # -- phase 12: bf16 main path ------------------------------------------
    say("[12] bf16 main path: solve_fast(precision='bf16') on the six paper "
        "topologies x {energy, time}, against phase 4's fp32 solves")
    ops.PDHG_BURST_BF16_LAUNCHES = 0
    for name in PAPER_TOPOS:
        p = problem(name, {}, GOLDEN_PATTERN, 2)
        for obj in OBJECTIVES:
            t0 = time.perf_counter()
            r = solver.solve_fast(p, obj, precision="bf16", device="cuda")
            wall = time.perf_counter() - t0
            verify.check_schedule(p, r.schedule).assert_ok(
                f"{name}/{obj} bf16 on the card")
            got, f32 = metrics_of(r), paper_fp32[name, obj]
            dE = rel_diff(got["energy_j"], f32["energy_j"])
            ratio = got["completion_s"] / f32["completion_s"]
            if obj == "energy":
                require(dE <= BF16_METRIC_RTOL and abs(ratio - 1.0)
                        <= BF16_METRIC_RTOL,
                        f"{name}/{obj} bf16: {got} vs fp32 {f32}")
            else:
                require(ratio <= BF16_COMPLETION_RATIO,
                        f"{name}/{obj} bf16: completion {ratio:.4f}x fp32")
            say(f"    {name:10s} {obj:6s} E={got['energy_j']:.6f} J "
                f"(fp32 {dE:.2e} rel) M={got['completion_s']:.6f} s "
                f"({ratio:.6f}x fp32) iters={r.iterations} "
                f"wall={wall:.3f} s cert=ok")
    t0 = time.perf_counter()
    r = solver.solve_fast(p_full, "energy", precision="bf16", device="cuda")
    wall = time.perf_counter() - t0
    verify.check_schedule(p_full, r.schedule).assert_ok("fat-tree-k16 bf16")
    require(r.remaining_gbits <= 1e-6, "fat-tree-k16 bf16: demand left")
    say(f"    fat-tree-k16 energy bf16: wall={wall:.3f} s "
        f"iters={r.iterations} primal={r.lp_primal_residual:.3e} "
        f"E={r.metrics.energy_j:.6f} J M={r.metrics.completion_s:.6f} s "
        f"cert=ok (fp32 in phase 5: E={full_fp32['energy']['energy_j']:.6f}"
        f" J M={full_fp32['energy']['completion_s']:.6f} s; reported)")
    bf16_launches = ops.PDHG_BURST_BF16_LAUNCHES
    say(f"    pdhg_burst_bf16 launches on this phase: {bf16_launches}")
    require(bf16_launches > 0, "phase 12 did not go through the bf16 kernel")

    # -- phase 13: the batched path at full size ---------------------------
    say(f"[13] batched path: fat-tree k=16, 20x12 shuffle, 120 Gbit, seeds "
        f"{BATCH_SEEDS[0]}-{BATCH_SEEDS[-1]}, energy, solve_fast_batch")
    t0 = time.perf_counter()
    probs8 = problems(*FULL, BATCH_SEEDS)
    lps8 = [solver.build_routing_lp(p, "energy")[0] for p in probs8]
    tols8 = [1e-4 * max(float(np.abs(lp.b).max(initial=0.0)), 1.0)
             for lp in lps8]
    say(f"    {len(probs8)} problems and LPs built in "
        f"{time.perf_counter() - t0:.3f} s")
    ops.PDHG_BURST_LAUNCHES = 0
    ops.PDHG_ADAPTIVE_CALLS = 0
    solver.reset_dispatch_stats()
    with stage_clock(batch_stages()) as spent:
        t0 = time.perf_counter()
        batch = solver.solve_fast_batch(probs8, "energy", device="cuda")
        batch_wall = time.perf_counter() - t0
    batch_calls = ops.PDHG_ADAPTIVE_CALLS
    batch_launches = ops.PDHG_BURST_LAUNCHES
    ds = solver.dispatch_stats()
    say(f"    (a) batch wall {batch_wall:.3f} s; pdhg_adaptive calls "
        f"{batch_calls}, pdhg_burst launches {batch_launches}; dispatches "
        f"{ds.dispatches}")
    for label, sec in spent.items():
        say(f"        stage {label}: {sec:.4f} s "
            f"({sec / batch_wall:.4f} of the wall)")
    top = sum(sec for label, sec in spent.items()
              if not label.startswith(" "))
    say(f"        stage the rest: {batch_wall - top:.4f} s "
        f"({(batch_wall - top) / batch_wall:.4f} of the wall)")
    require(batch_calls > 0 and batch_launches > 0,
            "phase 13 did not go through the adaptive driver and the kernel")
    solo_walls = []
    for seed, p, b, tol in zip(BATCH_SEEDS, probs8, batch, tols8):
        verify.check_schedule(p, b.schedule).assert_ok(f"batch seed {seed}")
        require(b.lp_primal_residual <= tol and b.remaining_gbits <= 1e-6,
                f"batch seed {seed}: residual {b.lp_primal_residual:.3e} "
                f"(tol {tol:.3e}), {b.remaining_gbits:.3e} Gbit left")
        t0 = time.perf_counter()
        s = solver.solve_fast(p, "energy", device="cuda")
        solo_walls.append(time.perf_counter() - t0)
        say(f"    seed {seed}: batch E={b.metrics.energy_j:.6f} J "
            f"M={b.metrics.completion_s:.6f} s iters={b.iterations} "
            f"primal={b.lp_primal_residual:.3e} cert=ok | solo "
            f"E={s.metrics.energy_j:.6f} J M={s.metrics.completion_s:.6f} s"
            f" iters={s.iterations} | rel dE "
            f"{rel_diff(b.metrics.energy_j, s.metrics.energy_j):.2e} dM "
            f"{rel_diff(b.metrics.completion_s, s.metrics.completion_s):.2e}")
    solo_wall = sum(solo_walls)
    say(f"    8 solo solve_fast {solo_wall:.3f} s against the batch's "
        f"{batch_wall:.3f} s ({solo_wall / batch_wall:.2f}x)")
    t0 = time.perf_counter()
    again = solver.solve_fast_batch(probs8, "energy", device="cuda")
    say(f"    (e) repeat wall {time.perf_counter() - t0:.3f} s")
    for seed, a, b in zip(BATCH_SEEDS, batch, again):
        require(np.array_equal(a.lp_x, b.lp_x) and np.array_equal(a.lp_y, b.lp_y)
                and np.array_equal(a.schedule, b.schedule)
                and a.iterations == b.iterations,
                f"batch seed {seed}: two runs differ")
    say("    (e) two batch runs bitwise identical (lp_x, lp_y, schedule)")
    fixed = solver.solve_lp_batch(lps8[:4], adaptive=False, device="cuda")
    for seed, lp, b in zip(BATCH_SEEDS, lps8[:4], fixed):
        single = solver.solve_lp(lp, device="cuda")
        err = float(np.abs(b.x - single.x).max())
        bitwise = np.array_equal(b.x, single.x)
        say(f"    (b) seed {seed} adaptive=False: iters {b.iterations} "
            f"(solo {single.iterations}), max|batch-solo| x {err:.3e}, "
            f"bitwise {bitwise}")
        require(err <= BATCH_X_ATOL and b.iterations == single.iterations,
                f"adaptive=False seed {seed}: x differs by {err:.3e}")
    dup = solver.solve_lp_batch([lp_full] * 8, device="cuda")
    require(all(np.array_equal(d.x, dup[0].x) and np.array_equal(d.y, dup[0].y)
                and d.iterations == dup[0].iterations for d in dup[1:]),
            "8 identical members differ")
    say(f"    (c) 8 copies of seed 0 in one adaptive batch: bitwise equal "
        f"({dup[0].iterations} iterations each)")
    freeze_check(lps8[:4], tols8[:4], dev)

    # -- phase 14: the sweep CLI on the card -------------------------------
    say("[14] sweep CLI on the card: python -m repro_torch.sweep "
        + " ".join(SWEEP_ARGS))
    from repro_torch.sweep import __main__ as sweep_main
    from repro_torch.sweep import runner
    tmp = None if sweep_out else tempfile.TemporaryDirectory()
    out = pathlib.Path(sweep_out or tmp.name)
    certs = []
    record = runner._record

    def certified(topo_name, obj, pat_name, seed, p, r, *a, **kw):
        # every row's final schedule (after the runner's retries)
        certs.append(verify.check_schedule(p, r.schedule).ok)
        return record(topo_name, obj, pat_name, seed, p, r, *a, **kw)

    ops.PDHG_BURST_LAUNCHES = 0
    ops.PDHG_ADAPTIVE_CALLS = 0
    t0 = time.perf_counter()
    with mock.patch.object(runner, "_record", certified):
        rc = sweep_main.main(SWEEP_ARGS + ["--out", str(out)])
    sweep_wall = time.perf_counter() - t0
    sweep_calls = ops.PDHG_ADAPTIVE_CALLS
    sweep_launches = ops.PDHG_BURST_LAUNCHES
    rows = sweep_rows(out / "results.csv")
    if tmp is not None:
        tmp.cleanup()
    n_cells = len({k[:3] for k in rows})
    say(f"    exit code {rc}, {len(rows)} rows in {n_cells} cells, wall "
        f"{sweep_wall:.3f} s ({sweep_wall / n_cells:.3f} s a cell); "
        f"pdhg_adaptive calls {sweep_calls}, pdhg_burst launches "
        f"{sweep_launches}; {len(certs)} rows' schedules certified, "
        f"{certs.count(False)} not ok")
    require(rc == 0 and len(rows) == 288, f"sweep: exit {rc}, {len(rows)} rows")
    require(all(r["feasible"] == "True" for r in rows.values()),
            "sweep: an infeasible row")
    require(len(certs) == len(rows) and all(certs),
            "sweep: a row whose schedule has no ok certificate")
    require(sweep_calls > 0 and sweep_launches > 0,
            "phase 14 did not go through the adaptive driver and the kernel")
    ref = sweep_rows(SWEEP_RESULTS)
    worst, n_in, misses, order_rows = (0.0, None), 0, [], []
    for key, row in rows.items():
        d = max(rel_diff(float(row[c]), float(ref[key][c]))
                for c in ("energy_j", "completion_s"))
        if d > worst[0]:
            worst = (d, key)
        if d <= SWEEP_RTOL:
            n_in += 1
        elif key in SWEEP_ORDER_SENSITIVE:
            require(math.isclose(d, SWEEP_ORDER_SENSITIVE[key],
                                 rel_tol=1e-3),
                    f"{key}: {d:.4e} off, expected "
                    f"{SWEEP_ORDER_SENSITIVE[key]:.4e}")
            order_rows.append(key)
        else:
            misses.append((key, d))
    say(f"    against results/sweep/results.csv (the reference's run): "
        f"{n_in} of {len(rows)} rows within {SWEEP_RTOL:g} on energy_j and "
        f"completion_s; worst {worst[0]:.3e} at {worst[1]}; rows flipped by "
        f"the summation order {len(order_rows)} of the "
        f"{len(SWEEP_ORDER_SENSITIVE)} listed")
    require(not misses, f"sweep rows off the committed results: {misses}")
    for key in order_rows:
        check_order_sensitive(key, rows[key], ref[key])
    t0 = time.perf_counter()
    cpu_recs, _ = runner.run_sweep(runner.SweepSpec(**SWEEP_CPU_CELLS,
                                                    device="cpu"))
    cpu_worst = 0.0
    for rec in cpu_recs:
        row = rows[rec.topo, rec.objective, rec.pattern, rec.seed]
        cpu_worst = max(cpu_worst, rel_diff(float(row["energy_j"]),
                                            rec.energy_j),
                        rel_diff(float(row["completion_s"]), rec.completion_s))
    say(f"    the same spec on this machine's CPU ({len(cpu_recs)} rows of "
        f"spine-leaf and pon3, uniform, seeds 0-1, {time.perf_counter() - t0:.1f}"
        f" s): worst relative difference {cpu_worst:.3e}")
    require(cpu_worst <= SWEEP_RTOL, "sweep: card and CPU rows differ")
    t0 = time.perf_counter()
    with in_kernel_order():
        ko_recs, _ = runner.run_sweep(runner.SweepSpec(**SWEEP_CPU_CELLS,
                                                       device="cpu"))
    ko_bad = [(r.topo, r.objective, r.pattern, r.seed) for r in ko_recs
              if row_differs(r, rows[r.topo, r.objective, r.pattern, r.seed])]
    say(f"    the same spec on the CPU in the kernel's summation order "
        f"({time.perf_counter() - t0:.1f} s): {len(ko_recs) - len(ko_bad)} of "
        f"{len(ko_recs)} rows bitwise the card's (every column but solve_s)")
    require(not ko_bad, f"sweep: rows the kernel-order model does not "
                        f"reproduce: {ko_bad}")
    cell = dict(topos=("pon3",), objectives=("energy",),
                patterns=("uniform",))
    again, _ = runner.run_sweep(runner.SweepSpec(**cell))
    for rec in again:
        bad = row_differs(rec, rows[rec.topo, rec.objective, rec.pattern,
                                    rec.seed])
        require(not bad, f"sweep repeat: {rec.topo}/{rec.seed} differs in "
                         f"{bad}")
    say(f"    pon3/uniform/energy run again: {len(again)} rows bitwise "
        f"equal to the CLI's (every column but solve_s)")

    # -- phase 15: times at the batched and bf16 shapes --------------------
    say(f"[15] times at the batched and bf16 shapes ({card})")
    bs8 = solver.block_stack(lps8)
    op8, args8 = lp_burst_args(bs8.lp, dev)
    kw8 = layout(op8, dev)
    say(f"    8-stack: n={bs8.lp.n} m={bs8.lp.m} nnz={len(bs8.lp.val)}; ELL "
        f"n_pad={op8.n_pad} m_pad={op8.m_pad} row slots {len(op8.rows.idx)}"
        f" col slots {len(op8.cols.idx)}; row widths "
        f"{min(op8.rows.widths)}..{max(op8.rows.widths)}")
    n_k8 = 1000
    ms8 = sorted(time_events(lambda: ops.pdhg_burst(*args8, iters=n_k8,
                                                    **kw8), 1) / n_k8
                 for _ in range(3))[1]
    ms8_sm = sorted(time_events(lambda: ops.pdhg_burst(
        *args8, iters=n_k8, _blocks=sms, **kw8), 1) / n_k8
        for _ in range(3))[1]
    plain8_ms = time_events(lambda: pdhg_spmv.pdhg_update_burst(
        args8[12], args8[13], *args8[:12], iters=5, **kw8), 1) / 5
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        K8 = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([bs8.lp.row, bs8.lp.col])),
            torch.from_numpy(bs8.lp.val.astype(np.float32)),
            (bs8.lp.m, bs8.lp.n), check_invariants=True).coalesce()
        K8c = K8.to_sparse_csr().to(dev)
        K8Tc = K8.t().coalesce().to_sparse_csr().to(dev)
    x8 = torch.rand(bs8.lp.n, 1, device=dev)
    y8 = torch.rand(bs8.lp.m, 1, device=dev)
    library8_ms = time_events(lambda: (K8c @ x8, K8Tc @ y8), 200)
    bound8_ms, bound8_by, bytes8, ops8 = burst_bound(op8, len(bs8.lp.val))
    say(f"    fp32 kernel, 8-stack  {ms8:.6f} ms/iter (burst of {n_k8}, "
        f"median of 3; the single instance {ms:.6f} in phase 6, "
        f"{ms8 / ms:.3f}x); on {sms} blocks (one an SM) {ms8_sm:.6f}")
    say(f"    plain, 8-stack        {plain8_ms:.6f} ms/iter (burst of 5)")
    say(f"    library, 8-stack      {library8_ms:.6f} ms per K.x + K^T.y "
        f"pair (torch CSR matmul)")
    say(f"    bound, 8-stack        {bound8_ms:.6f} ms/iter ({bound8_by}: "
        f"{bytes8} B at 3.35 TB/s, {ops8} fp32 ops at 67 TFLOP/s)")
    bf16_ms = sorted(time_events(lambda: ops.pdhg_burst(
        *args_full, iters=n_k, precision="bf16", **kw), 1) / n_k
        for _ in range(3))[1]
    bf16_ms_sm = sorted(time_events(lambda: ops.pdhg_burst(
        *args_full, iters=n_k, precision="bf16", _blocks=sms, **kw), 1) / n_k
        for _ in range(3))[1]
    bf16_plain_ms = time_events(lambda: pdhg_spmv.pdhg_update_burst(
        args_full[12], args_full[13], *args_full[:12], iters=n_p,
        precision="bf16", **kw), 1) / n_p
    bf16_bound_ms, bf16_bound_by, bf16_bytes, bf16_ops = burst_bound(
        op_full, len(lp_full.val), it=2)
    say(f"    bf16 kernel, single   {bf16_ms:.6f} ms/iter (burst of {n_k}, "
        f"median of 3; fp32 {ms:.6f}, {bf16_ms / ms:.3f}x); on {sms} "
        f"blocks (one an SM) {bf16_ms_sm:.6f}")
    say(f"    bf16 plain, single    {bf16_plain_ms:.6f} ms/iter (burst of "
        f"{n_p})")
    say(f"    bf16 bound, single    {bf16_bound_ms:.6f} ms/iter "
        f"({bf16_bound_by}: {bf16_bytes} B at 3.35 TB/s); library as in "
        f"phase 6, {library_ms:.6f} ms")
    busy = profile_device(lambda: solver.solve_fast_batch(
        probs8, "energy", device="cuda"))
    if busy is None:
        say("    batch device busy share: not measured (the profiler saw no "
            "device time)")
    else:
        busy_s = sum(us for _, us in busy.values()) * 1e-6
        say(f"    batch: device busy {busy_s:.3f} s of a {batch_wall:.3f} s "
            f"solve_fast_batch (idle share {1.0 - busy_s / batch_wall:.3f});"
            f" by kernel: " + ", ".join(
                f"{k} x{c} {us * 1e-3:.1f} ms"
                for k, (c, us) in sorted(busy.items())))
    say(f"    batch of 8 {batch_wall:.3f} s against 8 solo solve_fast "
        f"{solo_wall:.3f} s; sweep {sweep_wall / n_cells:.3f} s a cell")
    say(f"    total {time.perf_counter() - t_start:.1f} s")

    # -- phase 16: the scan kernel vs its plain version --------------------
    sc_info = build.BUILD_INFO["rglru_scan.cu"]
    say(f"[16] RG-LRU scan kernel vs its plain version on the card (built "
        f"in phase 2 in {sc_info['seconds']:.3f} s -> "
        f"{pathlib.Path(sc_info['library']).name})")
    for line in sc_info["log"].splitlines():
        if "registers" in line or "spill" in line:
            say(f"    ptxas: {line.strip()}")
    scan_errs = []
    cases = [(B, S, R, False) for B, S, R in SCAN_CASES] + [
        (B, S, R, True) for B, S, R in SCAN_MISALIGNED] + [
        (*SCAN_SERVE, False)]
    for seed, (B, S, R, skew) in enumerate(cases):
        a, b, h0 = scan_inputs(seed, B, S, R, dev)
        if skew:
            a, b = scan_misaligned(a), scan_misaligned(b)
        for with_h0 in (False, True):
            scan_errs.append(compare_scan(
                f"B={B} S={S} R={R}{' +4 B' if skew else ''} "
                f"h0={'given' if with_h0 else 'zeros'}",
                a, b, h0 if with_h0 else None))
    out = ops.rglru(a, b, h0)
    # a stage length whose ring the card refuses must raise, not fall back
    huge = 1 << 12
    try:
        ops._rglru_kernel(a, b, h0, huge)
        refused = False
    except RuntimeError as e:
        refused = True
        say(f"    a ring of {ops.scan_ring_bytes(huge)} B a block "
            f"(T = {huge}) raises: {e}")
    require(refused, "a scan launch asking more shared memory than the "
                     "card has did not raise")
    for name, wrong in (("ignores h0", scan_ignore_h0),
                        ("drops the last step", scan_drop_last_step),
                        ("rounds a*h + b once", scan_fused)):
        bad = scan_equal(wrong(a, b, h0), out)
        say(f"    negative control at {SCAN_SERVE}: a scan that {name} "
            f"passes the check: {bad}")
        require(not bad, f"the scan check passes a scan that {name}")
    scan_max_err = max(scan_errs)
    del a, b, h0, out

    # -- phase 17: recurrentgemma-2b serving at full width -----------------
    say("[17] serving path: recurrentgemma-2b at full width (26 layers, d "
        "2560, vocab 256,000), batch 4, prompt 4096, 32 tokens, impl=kernel")
    torch.cuda.reset_peak_memory_stats()
    rcfg = configs.get("recurrentgemma-2b")
    kinds = rcfg.pattern_for(rcfg.n_layers)
    n_rec, n_att = kinds.count("rglru"), kinds.count("attn_local")
    rserved = []
    for rep in range(2):
        ops.RGLRU_SCAN_LAUNCHES = 0
        ops.FLASH_ATTENTION_LAUNCHES = 0
        t0 = time.perf_counter()
        rserved.append(serve.main(RGEMMA_ARGS))
        wall = time.perf_counter() - t0
        scan_launches = ops.RGLRU_SCAN_LAUNCHES
        rfa_launches = ops.FLASH_ATTENTION_LAUNCHES
        say(f"    run {rep}: serve.main wall {wall:.3f} s (weights drawn on "
            f"the card included); rglru_scan launches {scan_launches}, "
            f"flash_attention launches {rfa_launches}")
        require(scan_launches == n_rec and rfa_launches == n_att,
                f"recurrentgemma prefill launched the scan kernel "
                f"{scan_launches} and the attention kernel {rfa_launches} "
                f"times, expected {n_rec} and {n_att}")
    require(rserved[0].shape == (4, 32), f"tokens {rserved[0].shape}")
    require(np.array_equal(rserved[0], rserved[1]),
            "two recurrentgemma serving runs differ")
    say(f"    two runs: identical tokens; {rserved[0][0][:8].tolist()} ...")
    rmodel, rtoks = serve.build(rcfg, 4, 4096, 0, dev)
    rprefill = steps.make_prefill_step(rcfg, impl="kernel",
                                       max_len=4096 + 32)
    rlogits, _ = rprefill(rmodel, {"tokens": rtoks})
    torch.cuda.synchronize()
    require(bool(torch.isfinite(rlogits).all()),
            "recurrentgemma logits not finite")
    require(np.array_equal(rlogits[:, -1].argmax(-1).cpu().numpy(),
                           rserved[0][:, 0]),
            "serve.main's first tokens are not this prefill's argmax")
    del rlogits
    compare_sublayers("recurrentgemma prefill", rmodel, rtoks)

    # -- phase 18: times at recurrentgemma's shapes ------------------------
    say(f"[18] times at recurrentgemma-2b's shapes ({card})")
    a, b, _ = scan_inputs(77, *SCAN_SERVE, dev)
    scan_ms = sorted(time_events(lambda: ops.rglru(a, b), 10)
                     for _ in range(3))[1]
    scan_plain_ms = time_events(lambda: scan_plain(a, b), 1)
    scan_bound_ms, scan_bound_by, scan_bytes, scan_flop = scan_bound(
        *SCAN_SERVE)
    cfg = ops.rglru_launch_config(*SCAN_SERVE, dev)
    # the stage length's neighbours, to show what the rule picks
    steps_ms = {t: sorted(time_events(lambda: ops._rglru_kernel(
        a, b, None, t), 10) for _ in range(3))[1]
        for t in sorted({8, cfg["steps"] // 2 // 8 * 8 or 8, cfg["steps"],
                         2 * cfg["steps"], 4 * cfg["steps"]})}
    del a, b
    say(f"    scan kernel   {scan_ms:.6f} ms a launch (a, b {SCAN_SERVE} "
        f"fp32; median of 3 runs of 10): "
        f"{scan_bytes / scan_ms * 1e-9:.3f} TB/s, "
        f"{scan_ms / scan_bound_ms:.3f}x its bound")
    say(f"    scan launch   {cfg['groups']} blocks of 32 threads, "
        f"{cfg['registers']} registers and {cfg['local_bytes']} B of local "
        f"memory a thread, {cfg['smem_bytes']} B of shared memory a block "
        f"({cfg['stages']} stages of {cfg['steps']} steps), "
        f"{cfg['blocks_per_sm']} blocks fit an SM")
    say("    scan stage length T, ms a launch (median of 3 runs of 10): "
        + ", ".join(f"T={t}: {ms:.6f}" for t, ms in steps_ms.items()))
    one = (1, *SCAN_SERVE[1:])
    a, b, _ = scan_inputs(78, *one, dev)
    one_ms = sorted(time_events(lambda: ops.rglru(a, b), 10)
                    for _ in range(3))[1]
    one_bound_ms, _, one_bytes, _ = scan_bound(*one)
    one_cfg = ops.rglru_launch_config(*one, dev)
    del a, b
    say(f"    scan at B=1   {one_ms:.6f} ms a launch ({one}, "
        f"{one_cfg['groups']} blocks, T={one_cfg['steps']}): "
        f"{one_bytes / one_ms * 1e-9:.3f} TB/s; bound {one_bound_ms:.6f} ms, "
        f"{one_ms / one_bound_ms:.3f}x")
    say(f"    scan plain    {scan_plain_ms:.6f} ms")
    say(f"    scan library  none: no single PyTorch call computes a "
        f"first-order linear recurrence")
    say(f"    scan bound    {scan_bound_ms:.6f} ms ({scan_bound_by}: "
        f"{scan_bytes} B at 3.35 TB/s, {scan_flop} fp32 ops at 67 TFLOP/s)")
    q, k, v = fa_inputs(98, 4, 4096, 10, 1, 256, torch.bfloat16, dev)
    rfa_ms = sorted(time_events(lambda: ops.flash_attention(
        q, k, v, window=2048), 3) for _ in range(3))[1]
    rfa_plain_ms = time_events(lambda: fa_plain(q, k, v, 2048, 0.0), 1)
    # yardstick: SDPA with the causal window as a boolean mask and the one
    # kv head repeated to the ten query heads
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).repeat_interleave(10, dim=1).contiguous()
              for t in (k, v))
    i = torch.arange(4096, device=dev)
    wmask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < 2048)
    rfa_lib_ms = time_events(lambda: sdpa(qt, kt, vt, attn_mask=wmask), 3)
    rfa_bound_ms, rfa_bound_by, rfa_bytes, rfa_flop = attention_bound(
        4, 4096, 10, 1, 256, 2048, 2)
    del q, k, v, qt, kt, vt
    say(f"    attention kernel {rfa_ms:.6f} ms a launch (q (4, 4096, 10, 256),"
        f" k/v (4, 4096, 1, 256), bf16, causal, window 2048; median of 3 "
        f"runs of 3)")
    say(f"    attention plain  {rfa_plain_ms:.6f} ms")
    say(f"    attention library {rfa_lib_ms:.6f} ms (torch "
        f"scaled_dot_product_attention, boolean window mask, kv repeated to "
        f"10 heads, (B,H,S,hd))")
    say(f"    attention bound  {rfa_bound_ms:.6f} ms ({rfa_bound_by}: "
        f"{rfa_flop} flop at 989 TFLOP/s bf16, {rfa_bytes} B at 3.35 TB/s)")
    say(f"    attention useful work {rfa_flop / rfa_ms * 1e-9:.3f} TFLOP/s; "
        f"the kernel takes {rfa_ms / rfa_bound_ms:.3f}x its bound and "
        f"{rfa_ms / rfa_lib_ms:.3f}x the library's time")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rprefill(rmodel, {"tokens": rtoks})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rprefill_wall = sorted(walls)[1]
    g = serve.generate(rmodel, rtoks, 32, impl="kernel")
    say(f"    recurrentgemma prefill wall {rprefill_wall * 1e3:.3f} ms "
        f"(median of 3); decode {g.decode_s / 31 * 1e3:.3f} ms a token (31 "
        f"steps, batch 4)")
    report_busy("prefill", lambda: rprefill(rmodel, {"tokens": rtoks}),
                rprefill_wall)
    rdecode = steps.make_decode_step(rcfg, impl="kernel")
    tok = g.tokens[:, -1:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rdecode(rmodel, g.caches, tok, 4096 + 31)
    torch.cuda.synchronize()
    report_busy("decode step", lambda: rdecode(rmodel, g.caches, tok,
                                               4096 + 31),
                time.perf_counter() - t0)
    say(f"    peak device memory in phases 17-18 "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; total "
        f"{time.perf_counter() - t_start:.1f} s")

    kernels = {"kernels": [{
        "name": "pdhg_burst", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": full_launches,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}, {
        "name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
        "replaces": FA_REPLACES, "launches": serve_launches,
        "max_abs_err": fa_max_err, "ms": fa_ms, "plain_ms": fa_plain_ms,
        "bound_ms": fa_bound_ms, "bound_by": fa_bound_by,
        "library_ms": fa_lib_ms}, {
        "name": "pdhg_burst_bf16", "route": "cuda", "source": SOURCE,
        "replaces": BF16_REPLACES, "launches": bf16_launches,
        "max_abs_err": bf16_max_err, "ms": bf16_ms,
        "plain_ms": bf16_plain_ms, "bound_ms": bf16_bound_ms,
        "bound_by": bf16_bound_by, "library_ms": library_ms}, {
        "name": "rglru_scan", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": SCAN_REPLACES, "launches": scan_launches,
        "max_abs_err": scan_max_err, "ms": scan_ms,
        "plain_ms": scan_plain_ms, "bound_ms": scan_bound_ms,
        "bound_by": scan_bound_by, "library_ms": None}]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
