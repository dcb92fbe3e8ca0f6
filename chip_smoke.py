#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and hold its kernel to account.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    PYTHONPATH=src python3 chip_smoke.py [--sweep-out DIR]

Phases, in order; any failure ends the script with a non-zero exit code.
Every solve of phases 3-32 names backend="pallas" (the sweep CLI's
--backend pallas): they hold the blocked-ELL lowering and its burst
kernel.  The default lowering, "xla" as in the reference, is phase 33's,
which drives the main path as a caller runs it, naming no backend; so do
the fabric planner's solves (core.fabric: phases 22, 28, 31 and 34).

  1. card check: a CUDA device, its name and power limit, TF32 off;
  2. build: the four CUDA kernels from src/repro_torch/kernels/csrc (the
     ELL and COO bursts, attention and scan kernels; one nvcc each,
     started together);
  3. kernel vs plain version on the card: random blocked-ELL operators
     (frozen coordinates, a mix of inequality rows) and the full-size LP,
     at 1 and 500 iterations: bitwise equal to the kernel-order model
     (the plain version summing each row as the kernel does), bitwise
     equal on two grids (as many blocks as fit, one block an SM), within
     the plain version's tolerance; a launch on more blocks than fit
     raises;
  4. main path, paper topologies: solve_fast on the card for six paper
     DCNs x {energy, time}; certificates, agreement with the port's own
     CPU solve (in helper processes meanwhile), and the committed pins of
     tests/golden/metrics.json;
  5. main path at full size: fat-tree k=16 (1,024 servers) x {energy,
     time}, each solved twice on the card; certificates, bitwise repeat,
     and the kernel's launch count; the profiler sees one burst kernel
     launch a burst and no other kernel of the burst;
  6. times at the full-size shapes: the kernel (as many blocks as fit,
     and one block an SM), its plain version, two CSR mat-vecs as a
     library yardstick, and the bound;
  7. build of the flash-attention kernel (phase 2): seconds, and each
     template's registers and spills (the bf16 wgmma / TMA kernel, one
     template per padded head dim, with its setmaxnreg split, and the fp32
     SIMT kernel, one template per padded head dim of its simt_plan); no
     spills in either, no serialized wgmma in the bf16 kernel, and no
     mma, wgmma or TF32 in the fp32 entry's source;
  8. attention kernel vs its plain version on the card: first a layout
     probe of the bf16 kernel on structured inputs at each padded head
     dim, reporting apart whether S = Q K^T's or O = P V's layout is
     wrong; then the grid of
     tests/test_kernels.py, a danube-shaped windowed case, the phi4 serving
     shape and recurrentgemma's (hd 256, one kv head, window 2048), a
     ragged S = T = 1000, two non-causal cases, hd 100 (zero-padded to
     104 by the wrapper) and B*H = 65,600 (past the 65,535 limit of a
     grid's y axis), each in fp32 and bf16,
     each element within its tolerance (fp32: 2e-5 + 2e-5 of the element;
     bf16: one bf16 place more), two launches bitwise equal; an attention
     that drops the last kv tile, and one that rounds p once to bf16 in
     p.v, must fail the same check; q, k and v as contiguous views 4
     bytes past a 16-byte boundary (the wrapper copies them onto one) at
     a causal GQA shape, fp32 and bf16, bitwise the same call on aligned
     copies;
  9. serving path at full width: `launch.serve.main` on phi4-mini-3.8b
     (batch 4, prompt 2048, 32 tokens), run twice: 32 kernel launches a
     prefill, identical tokens, finite logits; in every layer the
     attention sublayer through the kernel agrees with it through the
     plain version within bf16 places, and fails with the dropped tile;
     then h2o-danube-3-4b cut to 4 layers (batch 1, prompt 6144, 8 tokens)
     for the window, hd=120 and the ring-buffer cache;
 10. times at the serving shapes: the attention kernel, its plain
     version, torch's scaled_dot_product_attention as a library
     yardstick, the bound and the useful TFLOP/s reached; the fp32 SIMT
     entry at the same shape in fp32 beside SDPA in fp32 and its bound at
     the fp32 FMA rate, with its tile plan; prefill wall, decode ms a
     token, and the device's busy share of one prefill;
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
     results/sweep/results.csv and against the port's CPU run of 4 rows,
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
     decode step by kernel;
 19. failures at full size: phase 13's 8-stack degraded under link3 (all
     eight members) and switch (the first two; one scenario a seed, a
     sparsity pattern a member), re-solved
     by solve_fast_ensemble warm from the healthy results and cold:
     every schedule certified, warm served equal to cold to 1e-6, energy
     within 5%, fewer warm iterations, the warm dispatch repeated and
     each member solved alone from its projected start bitwise equal,
     switch's bf16 warm ensemble certified; the burst bitwise equal to its
     summation-order model from the projected start (fp32 and bf16, 1
     and 250 iterations) and timed at the warm degraded stack beside its
     plain version, two CSR mat-vecs and its bound; the ensemble's stage
     clock (projection, LP builds, ELL plans and work lists, the adaptive
     driver, assembly);
 20. online arrivals: tests/test_arrivals.py's heavy trace through
     run_online on the card, against the CPU within 1e-4 or, where the
     two differ, bitwise equal to the CPU in the kernel's summation
     order; its one-epoch case equal to solve_fast on the card (the same
     rule); the flagship shuffle arriving as a 4-co-flow poisson trace on
     fat-tree k=16, warm and cold: epochs, iterations, conservation, the
     wall an epoch split into the adaptive driver and the host;
 21. chaos replay: the storm preset over both traces with the "scf"
     fallback tier, as the reference's chaos cells run it, twice on the
     card (byte-identical chaos logs, event traces and epochs), every
     epoch certified, demand conserved, the storm hitting an epoch with
     demand; the heavy trace also on the CPU under phase 20's rule;
 22. the sweep's --failures, --arrivals and --chaos axes at their tests'
     sizes, each row against the CPU under phase 20's rule, and --chaos's
     chaos_events.log; plan_collectives(v5e_fabric()) on the card, in the
     default lowering (the COO kernel launched, the ELL burst not),
     against the CPU;
 23. baseline policies: the golden policy grid (spine-leaf and pon3 x
     energy/time x ecmp, least-loaded, scf) on the card against its pins
     (metrics within 1e-4, gaps within 5e-3), then policy_bench's default
     cells (spine-leaf and pon3, 10 x 6 of 30 Gbit) and the flagship
     (against phase 5's LP): all five policies, fair-lp through the
     burst kernel, each certified with gap_vs_lp >= 1 - 1e-4, the
     heuristics bitwise their CPU run, each policy's wall beside the LP's;
 24. placement search: the four pinned SA runs, each twice on the card
     (identical trajectories: every dispatch's candidates and scores),
     against their pins, or where the port's CPU run misses a pin too
     (spine-leaf min-time) against that run; the committed placement
     run (docs/PLACEMENT.md, 144 rows, no oracle spot-check) against
     results/placement/results.csv under phase 14's rule, a row off it
     re-derived on the host CPU in both summation orders; evaluations a
     second, dispatches, and one generation's stage clock;
 25. the multi-tenant service: the golden two-tenant run (verified
     schedules) against its pin, two card runs with byte-identical
     event logs; service_bench's workload (12 tenants a topology) in
     "measured" mode coalesced against serial: equal tenant metrics,
     co-flows a second, p50/p99 decision latency, dispatches a window,
     the device's idle share; two fat-tree k=16 tenants of the flagship
     shuffle (2 poisson co-flows each, shortest paths); the sweep's
     --service 2 mode and its service_events.log;
 26. serving the rest of the zoo at full width, batch 4, prompt 2048, 16
     tokens, impl=kernel, one config's weights on the card at a time:
     granite-moe-1b-a400m (24 layers), qwen2-moe-a2.7b (12 of its 24
     layers, for memory), xlstm-1.3b (48 blocks), seamless-m4t-large-v2
     (24 decoder and 24 encoder layers, 32 encoder frames) and
     internvl2-1b (256 image tokens before the prompt), each served twice
     (serve.main, or build + generate): identical tokens, finite logits,
     24, 12, 0, 24 and 24 attention launches a prefill; in every
     attention layer the self-attention sublayer through the kernel
     within bf16 places of the plain version, failing with the dropped
     kv tile; in every MoE layer the routing (top-k in order, slots, kept
     pairs, expert counts) bitwise the CPU's from the card's router
     logits; the first mLSTM and sLSTM blocks of xlstm against the CPU
     (their recurrences on the same fp32 inputs within 1e-4 of scale,
     the blocks within 2e-2);
 27. times at those shapes: each config's prefill wall, decode ms a
     token, the device's busy share of one prefill and one decode step
     and its peak device memory; the attention kernel at granite's shape
     (H 16, Hkv 8, hd 64, S 2048) and internvl2's (H 14, Hkv 2, hd 64,
     S 2304) against its plain version, torch SDPA and its bound;
 28. training at full width through `launch.train.main` (the einsum path
     under autograd with remat, deterministic algorithms on; no kernel:
     none has a backward): phi4-mini-3.8b cut to 8 of its 32 layers
     (batch 2 x 2048, 6 steps, checkpoints every 3 steps) and
     granite-moe-1b-a400m uncut (batch 4 x 2048, 4 steps), each run twice
     from --seed 0 with losses, grad norms and a checksum of the final
     parameters bitwise equal, every loss and norm finite (granite's aux
     finite and positive); phi4's step-6 checkpoint left unwritten (one
     17 GB save, step 3's) with LATEST naming it, and the run resumed
     from step 3 through the stale-LATEST fallback (its own step-6 save
     skipped too), repeating losses 3-5 bitwise; remat on and off bitwise
     (granite at 4 layers);
     granite's loss falling over 8 steps on one batch; microbatches=2
     against 1 at tests/test_microbatch.py's tolerance; the ten smoke
     configs' gradients on the card against the host CPU (loss 2e-2,
     norm 2e-2, each leaf 5e-2 of its scale as the CPU tests hold the
     port to the reference; MoE routing bitwise from the card's logits);
 29. times of a train step at phase 28's shapes: the median step, tokens
     a second, model TFLOP/s (counted as printed), the device's busy
     share, the forward, backward and AdamW parts, peak device memory,
     granite's MoE dispatch against its backward, and each checkpoint's
     write and read.
 30. the row-sharded PDHG solve: the split step's registers and spills;
     (a) the burst kernel's split step (fp32 and bf16; one process
     holding 1, 2 and 4 shards of the flagship LP, a burst one
     cooperative launch, on as many blocks as fit and on one block an
     SM, 50 and 7 iterations) bitwise the plain sharded body in the
     kernel's order, and at one shard the fused kernel; (b) the sharded
     driver at world 1 over NCCL (a burst plan reused across the
     ladder's rungs, its iterations a CUDA graph replayed) bitwise the
     fused burst (energy and time, fp32; bf16's first rung), graph
     replays required, and a graph-replayed burst bitwise the same
     plan's eager launches and the burst without a collective; (c) 2
     ranks sharing the card over gloo, processes of
     this script (--shard-rank): solve_fast(shards=2) on spine-leaf
     (twice) and the flagship, x the same on every
     rank and from run to run, certified, within 1e-4 of phases 4-5, and
     a fixed burst twice, bitwise the host CPU's single-process model in
     the kernel's order; (d) ms an iteration of the split form at world 1
     over NCCL (the graph, and the same step launched eagerly), without a
     collective, and at 2 ranks, beside the fused burst, the collective's
     share (and gloo's gather of the CUDA tensors without the pinned
     staging), the bound, and the split step's own device time at world
     1, with no collective and over NCCL (torch's profiler: the kernel's
     durations; and a step launch relaunched back to back between CUDA
     events on a stream kept ahead of the host: the stream's time a
     launch).  The ranks start first and set up while this process runs
     (a), (b), (d) and phase 31 at world 1, then wait for it;
 31. the scheduled gradient all-reduce (runtime.collectives): phi4-mini's
     gradient tree (8 layers) bucketed at 25 MB and planned by
     core.fabric.plan_collectives, synced at world 1 over NCCL bitwise
     the input in the plan's slot order; a small tree of distinct
     gradients synced at 2 ranks over gloo equal to the plain mean.
 32. the sharded steps (runtime.sharding strategies on DTensor): (a) at
     world 1 over NCCL on a 1 x 1 (data, model) mesh, one train step of
     phi4-mini (phase 28's width, depth and start state) under fsdp and
     under 2d, metrics and every updated parameter bitwise the unsharded
     step's (the loss within 5e-3 in any case); (b) phi4-mini's serving
     prefill under 2d (phase 9's batch, prompt and 32 layers, the
     attention kernel launched through its DTensor wrapper) and 8 decode
     steps on cache_spec'd caches, logits, caches and tokens bitwise the
     unsharded run's; (c) on phase 30's two ranks, over gloo (its
     all_gather of CUDA tensors staged through pinned host memory): an
     8-layer prefill under 2d on a 1 x 2 model mesh, each rank's kernel
     at its local heads, logits equal on both ranks and within one bf16
     place of world 1's at 1 layer; at 8 layers the witness of the
     drift, in fp32 on the einsum path: each layer fed world 1's input
     within one bf16 place of world 1's output; and a 2-layer train step
     under fsdp on a 2 x 1 data mesh, loss within 5e-3 of world 1's and
     every parameter equal on both ranks; (d) the dry run's train_4k
     cells at 16 x 16: phi4-mini under its default strategy, granite-moe
     and qwen2-moe each under "auto" (their "2d") and fsdp, run one after
     another by a helper process started at the top (meta tensors and a
     fake world: host time only) and collected here: ok, all-gathers and
     reduce-scatters counted, flops a rank within 10% of the model's
     count (tests/test_torch_dryrun.py's and tests/test_torch_moe_dryrun.py's
     bound and formulas), torch's release, the largest ops; the attention
     kernel at a rank's shape against its plain version, timed beside
     SDPA, and its bound.
 33. the default COO lowering (backend="xla", as in the reference),
     every call of (b)-(f) naming no backend and holding that the COO
     kernel launched and no ELL kernel did: (a) the COO
     burst kernel (pdhg_coo.cu) against its plain version on CPU tensors
     from the same inputs (torch's CUDA index_add_ adds in no fixed
     order) at the flagship's energy and min-time LPs (the latter with
     its theta column of 1,778 entries), 1 and 500 iterations, cold and
     from a random start with a fifth of the coordinates held: bitwise,
     also on one block an SM; a launch on one block more than fit
     raises; a plain version rounding the two updates twice must fail;
     (b) solve_fast on the six paper topologies x {energy, time}:
     certified, two card runs and the host CPU's plain path bitwise
     equal, within 1e-4 of the golden pins (spine-leaf, pon3) or of
     phase 4; (c) the 8-stack through solve_fast_batch, each member's LP
     bitwise its solo solve, and the sweep CLI over phase 14's
     spine-leaf energy/skew rows, the backend column xla, every row
     within 1e-4 of results/sweep/results.csv, the
     summation-order-sensitive seed 5 included; (d) the kernel's ms an iteration at the flagship (energy
     and min-time) and the 8-stack, its plain version's on the host, its
     bytes bound, its order bound (the longest chain of dependent adds a
     step at one add's latency, measured by the kernel's add-chain
     entry) and phase 6's and 15's CSR mat-vecs; (e) run_online warm on
     phase 20's heavy trace, bitwise the host CPU's plain path in every
     epoch; (f) solve_fast on the flagship, each objective twice:
     certified, bitwise repeated, within 1e-4 of phase 5's ELL solves,
     with its walls.
 34. the seven examples (examples_torch/), each run's `run` on the card
     at EXAMPLE_SIZES: quickstart on pon3 (the oracle's time limit the
     reference's), pattern_sweep and failure_sweep at 2 seeds (the
     latter under link1 alone), online_arrivals, coflow_schedule and
     serve_batch as they are, train_lm for 3 steps; the four that solve
     under both lowerings.  Every schedule certified; each run's printed
     numbers within 1e-4 of the same call on the host CPU (a helper
     process started at the top) under "pallas" (where they differ
     more, phase 20's order rule: bitwise the CPU summing in the
     kernel's order; the warm heavy trace flips so), bitwise under "xla"
     (coflow_schedule's plans among them: the default lowering);
     serve_batch's tokens equal to the host CPU's greedy decode of the
     same weights up to a row's first near tie; train_lm (at the smoke
     width and 2 layers) resumed on the card and on the host from one
     draw of its weights, each of the three losses within 2e-2 of the
     host's; the ELL and COO bursts, attention and scan kernels each
     launched; the phase's wall.

Each phase's wall is printed when the next begins ("wall: phase N"), and
all of them, with phases 1-18's sum, before the kernels line.  The last
lines are one JSON object describing the kernels, the card's name and
power limit, and `{"ok": true, "device": {...}}`.  Imports
torch, numpy, scipy and repro_torch only.  Right after the card check
the script starts a pool of two spawned processes of itself on the host
CPU, one thread each (start_helpers: phase 32(d)'s five cells in one,
phase 34's CPU runs of the examples in the other); the phase that reads
one waits for it (HELPER_TIMEOUT_S after its start at most), a helper
that fails fails the phase, and any still running when the script ends
is killed.  Phase 24 starts
helper processes of this script (--placement-cpu, on the host CPU only), phase
30 two (--shard-rank, on the card) and phases 4 and 33 a pool of six each
(the paper cells' CPU solves, and phase 33(a)'s plain bursts); each
waits for all of its processes before it goes on, and phases 24 and 30
kill any still running at their time limit.
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import json
import math
import os
import pathlib
import re
import shutil
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
# (B, S, H, Hkv, hd): phase 8's views 4 bytes past a 16-byte boundary,
# causal GQA
FA_MISALIGNED = (2, 384, 8, 2, 64)
SERVE_ARGS = ["--arch", "phi4-mini-3.8b", "--batch", "4", "--prompt-len",
              "2048", "--gen", "32", "--impl", "kernel"]
# keys the negative control drops: the fp32 kernel's kv tile, half of the
# bf16 kernel's at hd 128 (kernels/flash_attention.py::tile_plan)
KV_TILE = 64
# bf16 storage against fp32 (tests/test_precision.py): energy-objective
# metrics within 1e-3, time-objective completion within 1.25x
BF16_METRIC_RTOL = 1e-3
BF16_COMPLETION_RATIO = 1.25
# the batched path: the flagship problem at these seeds
BATCH_SEEDS = tuple(range(8))
# adaptive=False against solve_lp (tests/test_solver_batch.py:38)
BATCH_X_ATOL = 1e-6
# the sweep: the reference's default grid over the six paper topologies
# under the blocked-ELL lowering, held to the committed results of the
# reference's run (xla lowering; phase 33(c) runs the default, xla)
SWEEP_ARGS = ["--topos", ",".join(PAPER_TOPOS), "--oracle-check", "0",
              "--backend", "pallas"]
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
# the rows run again on the host CPU in both summation orders (seed 0
# alone, for the script's time limit: 4 rows)
SWEEP_CPU_CELLS = dict(topos=("spine-leaf", "pon3"), patterns=("uniform",),
                       seeds=(0,))
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
# failures: the 8-stack degraded under these presets (one scenario a seed),
# held to the reference's bands (tests/test_failures.py): warm served
# equal to cold to 1e-6, energy within 5%
FAIL_PRESETS = ("link3", "switch")
# members degraded under each preset: link3 keeps all eight (and the
# burst's order model and row 1d's times); switch runs the first two and
# the bf16 warm ensemble, for the script's time limit
FAIL_MEMBERS = {"link3": 8, "switch": 2}
FAIL_BF16_PRESETS = ("switch",)
WARM_SERVED_RTOL = 1e-6
WARM_ENERGY_BAND = 0.05
# the warm burst against its summation-order model: one step and one
# adaptive chunk from the projected start
WARM_ORDER_ITERS = (1, 250)
# online arrivals: tests/test_arrivals.py's heavy trace (spine-leaf,
# uniform 4 x 3 of 48 Gbit, 4 poisson co-flows 2 s apart on average,
# seed 0, epochs of 1 s) and its one-epoch case (3 co-flows of 6 Gbit at
# t = 0); then the flagship shuffle (fat-tree k=16, uniform 20 x 12 of
# 120 Gbit, shortest paths) arriving as a poisson trace, cut to
# FT_COFLOWS co-flows for time, with epochs of one slot so that flows
# carry residuals from epoch to epoch
HEAVY = dict(n_map=4, n_reduce=3, total_gbits=48.0)
LIGHT = dict(n_map=4, n_reduce=3, total_gbits=6.0)
ONLINE_KW = dict(epoch_s=1.0, iters=3000)
FT_COFLOWS = 4
FT_ONLINE_KW = dict(epoch_s=1.0, path_slack=0)
# chaos: the storm preset's trace seed for each of those traces.  Seed 0's
# first storm is active at the heavy trace's boundaries from 3 s on; on
# the fat-tree trace its storms fall between the boundaries at 1 s and
# 4 s and net to no change, so that trace takes seed 1, whose first
# storm is active at the 4 s boundary, where its fourth co-flow arrives
STORM_SEEDS = {"heavy": 0, "ft": 1}
# the sweep's new axes at their tests' sizes (tests/test_failures.py and
# tests/test_arrivals.py)
SWEEP_FAILURES_ARGS = ["--topos", "spine-leaf", "--objectives", "energy",
                       "--patterns", "uniform", "--seeds", "2",
                       "--total-gbits", "6", "--n-map", "4", "--n-reduce",
                       "3", "--iters", "1200", "--oracle-check", "0",
                       "--backend", "pallas", "--failures", "link1"]
SWEEP_ARRIVALS_ARGS = ["--topos", "spine-leaf", "--objectives", "energy",
                       "--patterns", "uniform", "--seeds", "1",
                       "--total-gbits", "8", "--n-map", "4", "--n-reduce",
                       "3", "--iters", "1200", "--oracle-check", "0",
                       "--backend", "pallas", "--arrivals", "poisson",
                       "--arrival-coflows", "3"]
SWEEP_CHAOS_ARGS = ["--topos", "spine-leaf", "--objectives", "energy",
                    "--patterns", "uniform", "--seeds", "1",
                    "--total-gbits", "8", "--n-map", "4", "--n-reduce", "3",
                    "--iters", "1200", "--oracle-check", "0", "--backend",
                    "pallas", "--chaos", "storm"]
# the columns a sweep row is held to across devices
SWEEP_ROW_COLS = ("energy_j", "completion_s", "survivability",
                  "degradation_ratio", "mean_response_s", "backlog_gbits",
                  "epochs", "remaining_gbits", "availability",
                  "stranded_gbits", "recover_s", "deferred_gbits")
# policies: tests/test_golden_metrics.py's policy grid, held to its pins
# (metrics within METRIC_RTOL, gaps within GAP_RTOL: the LP denominator
# moves with the lowering); then benchmarks/policy_bench.py's default
# cells and the flagship, all five policies against the LP
GOLDEN_POLICIES = ("ecmp", "least-loaded", "scf")
GAP_RTOL = 5e-3
POLICY_BENCH_PATTERN = dict(n_map=10, n_reduce=6, total_gbits=30.0)
# placement search: tests/test_golden_metrics.py's pinned SA runs, then
# the committed placement run (docs/PLACEMENT.md; its results.csv holds
# the uniform pattern's rows only), without its oracle spot-check (the
# MILP is host work the card does not touch)
SEARCH_CFG = dict(method="sa", seed=0, generations=2, population=6,
                  iters=1500, backend="pallas")
# the pin the port's CPU run misses, and where the test that names the
# flipped comparison lives (ROADMAP queue 3)
SEARCH_PIN_FLIPS = {("spine-leaf", "time"): "the seed generation's "
                    "incumbent choice flips on a one-ulp tie; "
                    "tests/test_torch_search.py"}
PLACEMENT_ARGS = ["--topos", "spine-leaf,pon3", "--patterns", "uniform",
                  "--placement-search", "sa,ga", "--seeds", "4", "--n-map",
                  "6", "--n-reduce", "4", "--total-gbits", "20",
                  "--oracle-check", "0", "--backend", "pallas"]
PLACEMENT_RESULTS = ROOT / "results" / "placement" / "results.csv"
# a card row off the committed one is re-derived on the host CPU (its
# search, or its LP cell), in torch's and the kernel's summation order,
# in processes of this script's own, this many at a time
PLACEMENT_CPU_WORKERS = 6
# the service: the golden two-tenant run (tests/test_golden_metrics.py),
# benchmarks/service_bench.py's default workload (per topology 12
# tenants of 3 poisson co-flows, 3 x 2 flows of 36 Gbit, 1 s apart on
# average, tol 2e-3), and two flagship tenants on fat-tree k=16 with the
# flagship cell's shortest paths (path_slack 0; the service's default
# of 2 admits about twice the edges, and the run took 53-67 s)
SERVICE_BENCH = dict(tenants=12, coflows=3, mean_s=1.0, iters=3000,
                     tol=2e-3, pattern=dict(n_map=3, n_reduce=2,
                                            total_gbits=36.0))
SERVICE_FT_COFLOWS = 2
SERVICE_SWEEP_ARGS = ["--service", "2", "--topos", "spine-leaf,pon3",
                      "--patterns", "uniform", "--total-gbits", "8",
                      "--n-map", "4", "--n-reduce", "3",
                      "--arrival-coflows", "2", "--backend", "pallas"]
# the rest of the model zoo at full width (phases 26-27): (arch, layers
# kept, None for all), each at batch 4, prompt 2048, 16 tokens.
# qwen2-moe keeps 12 of its 24 layers: its fp32 weights and their bf16
# copies take about 86 GB at 24 layers, 45 GB at 12
ZOO = [("granite-moe-1b-a400m", None), ("qwen2-moe-a2.7b", 12),
       ("xlstm-1.3b", None), ("seamless-m4t-large-v2", None),
       ("internvl2-1b", None)]
ZOO_BATCH, ZOO_PROMPT, ZOO_GEN = 4, 2048, 16
# the xLSTM recurrences, card against CPU on the same fp32 inputs, of
# each output's scale: fp32 sums of up to 1,024 terms in cuBLAS's order
# and the CPU's (8.9e-6 measured at xlstm-1.3b's first mLSTM layer, on
# an NVIDIA H100 80GB HBM3); the whole block, whose bf16 products may
# round differently on the two, within the CPU tests' one-layer 2e-2
XLSTM_RTOL = 1e-4
XLSTM_BLOCK_RTOL = 2e-2
# phase 27's attention shapes: (name, B, S, H, Hkv, hd), causal, bf16
ZOO_FA = [("granite-moe", 4, 2048, 16, 8, 64),
          ("internvl2", 4, 2304, 14, 2, 64)]


# phases 28-29: training through launch.train.main at full width (phi4-mini
# cut to 8 of its 32 layers: its fp32 weights, gradients and moments take
# 61 GB at 32 layers, and the bf16 casts and the CE's fp32 logits push the
# step to about 75 GB of the card's 80)
TRAIN_RUNS = [("phi4-mini-3.8b", ["--n-layers", "8", "--batch", "2",
                                  "--seq", "2048"], 6),
              ("granite-moe-1b-a400m", ["--batch", "4", "--seq", "2048"], 4)]
TRAIN_RESUME = "phi4-mini-3.8b"
# granite's remat and learning checks
TRAIN_CHECK_BS = (4, 2048)
TRAIN_CKPT_EVERY = 3
TRAIN_SMOKE = ("phi4_mini_3_8b", "nemotron_4_15b", "gemma2_27b",
               "h2o_danube_3_4b", "recurrentgemma_2b", "granite_moe_1b_a400m",
               "qwen2_moe_a2_7b", "seamless_m4t_large_v2", "internvl2_1b",
               "xlstm_1_3b")
# tests/test_torch_train.py's tolerances against the reference
TRAIN_LOSS_TOL = 2e-2
TRAIN_NORM_RTOL = 2e-2
TRAIN_GRAD_TOL = 5e-2
# tests/test_microbatch.py's
MB_LOSS_TOL = 1e-5
MB_ATOL = 2e-5
MB_RTOL = 2e-4
# phase 30: the row-sharded solve.  The split step of pdhg_burst.cu
# replaces the sharded form of the burst's body (plain jnp under shard_map
# there); (a) holds it to the plain body in the kernel's order on the
# flagship LP at these shard counts and storage types, over these
# iterations (an even and an odd count: the graph's pairs and its tail)
SHARD_REPLACES = "src/repro/kernels/pdhg_spmv.py:450"
SPLIT_CASES = ((1, ("fp32", "bf16")), (2, ("fp32", "bf16")), (4, ("fp32",)))
SPLIT_ITERS = (50, 7)
# (c): ranks sharing the one card over gloo, processes of this script;
# their x after this many iterations against the host CPU's model
SHARD_WORLD = 2
# (c)'s paper topologies at SHARD_WORLD ranks (the first twice), then the
# flagship; the rest of PAPER_TOPOS is left out for the script's time
# limit (gloo paces an iteration at about 2.5 ms there)
SHARD_RANK_TOPOS = ("spine-leaf",)
SHARD_FIXED_ITERS = 20
SHARD_TIMEOUT_S = 400
# (d): bursts timed at world 1 and at SHARD_WORLD ranks (where gloo's
# all_gather of the partials, about 1.1 ms between two processes of one
# host, sets the pace), and the plain body's
SHARD_TIME_ITERS = 500
# (d): the split step's own time: a step launch relaunched SPLIT_OWN_REPS
# times between two CUDA events behind a sleep of this many cycles (about
# 25 ms, longer than the host takes to enqueue them), and in the profiler
# over a burst of SPLIT_OWN_ITERS
SPLIT_SLEEP_CYCLES = 50_000_000
SPLIT_OWN_ITERS = 50
SPLIT_OWN_REPS = 200
SHARD_RANK_TIME_ITERS = 200
SHARD_PLAIN_ITERS = 20
# phase 31: the scheduled gradient all-reduce over phi4-mini's gradient
# tree cut to phase 28's 8 layers, bucketed at 25 MB; the 2-rank sync
# against the plain mean (tests/test_torch_collectives.py's tolerance)
GRAD_LAYERS = 8
GRAD_BUCKET_BYTES = 25e6
SYNC_RTOL = 1e-6
# phase 32: the sharded steps (runtime.sharding on DTensor).  (a) phi4-mini
# at phase 28's width and depth from its start state (launch.train's seed
# 0 model, the data stream's first batch); (b) phase 9's serving prefill
# (batch 4, prompt 2048, all 32 layers) and decode steps; (c) at the
# SHARD_WORLD ranks: a 1 x 2 "model" mesh prefill (layers, batch, prompt)
# and a 2 x 1 "data" mesh train step (layers, batch, seq); (d) one dry-run
# cell at 16 x 16
SHARDED_TRAIN = (8, 2, 2048, 6)      # layers, batch, seq, launcher steps
SHARDED_SERVE = (4, 2048)            # batch, prompt
SHARDED_DECODE = 8
SHARDED_TP = (8, 4, 2048)
SHARDED_FSDP = (2, 2, 2048)
SHARDED_LOSS_TOL = 5e-3              # tests/test_distributed.py's
SHARDED_DRYRUN = ("phi4_mini_3_8b", "train_4k")
# (d)'s cells (arch, strategy), all at SHARDED_DRYRUN's shape: phi4 and
# the MoE train cells under their default strategy ("auto": 2d) and
# under fsdp, run by a helper process started at the top
DRYRUN_CELLS = ((SHARDED_DRYRUN[0], "auto"),
                ("granite_moe_1b_a400m", "auto"),
                ("granite_moe_1b_a400m", "fsdp"),
                ("qwen2_moe_a2_7b", "auto"), ("qwen2_moe_a2_7b", "fsdp"))
DRYRUN_TOP_OPS = 16                  # (d) prints the cell's largest ops
# (d): flops a rank against the model's count (tests/test_torch_dryrun.py's
# FLOP_RTOL and formula)
DRYRUN_FLOP_RTOL = 0.10
# the collectives gloo is handed on pinned host copies of the CUDA tensors
# (host_staged): on the H100 host (torch 2.11) its all_gather_into_tensor
# of CUDA tensors ends the process (a segmentation fault) and its
# all-to-all of them returns wrong data (a 2-rank attention input off by
# 14 of 112); its reduce-scatter and all-reduce take them
SHARDED_STAGED = ("_c10d_functional.all_gather_into_tensor.default",
                  "_c10d_functional.all_to_all_single.default",
                  "_dtensor.shard_dim_alltoall.default")
# phase 33: the reference's default COO lowering (backend="xla") on the
# card.  The kernel (pdhg_coo.cu) replaces no pallas_call: it runs the
# reference's XLA scatter-adds (src/repro/core/solver.py:105-173, the
# update's body) in their COO order
COO_SOURCE = "src/repro_torch/kernels/csrc/pdhg_coo.cu"
COO_REPLACES = "src/repro/core/solver.py:105"
COO_ITERS = (1, 500)
COO_THREADS = 512                    # threads a block: pdhg_coo.cu's kThreads
# phase 4 and phase 33(a)-(b): helper processes that solve the paper
# cells on the host CPU (and run the COO plain version's bursts)
CPU_WORKERS = 6
COO_FROZEN = 0.2                     # share of coordinates held in (a)
# (d): the add chains timed for one add's latency (adds, multiples of 8)
COO_ADD_CHAIN = (1 << 20, 1 << 21)
# (c): phase 14's order-sensitive sweep rows, on the card with no
# --backend (the default, xla; the sweep's defaults: 8 seeds, 30 Gbit,
# 10 x 6 tasks)
COO_SWEEP_ARGS = ["--topos", "spine-leaf", "--objectives", "energy",
                  "--patterns", "skew", "--oracle-check", "0"]
# the counters of the blocked-ELL lowering's kernels, none of which a
# call that names no backend may launch
ELL_COUNTERS = ("PDHG_BURST_LAUNCHES", "PDHG_BURST_BF16_LAUNCHES",
                "PDHG_SPLIT_LAUNCHES", "PDHG_SPLIT_BF16_LAUNCHES")

# phase 34: the seven examples (examples_torch/) on the card, each run's
# keyword sizes; those that solve run under both lowerings.  The host
# CPU's runs of the same calls are helper processes started at the top
EXAMPLES = ("quickstart", "pattern_sweep", "failure_sweep",
            "online_arrivals", "coflow_schedule", "serve_batch", "train_lm")
EXAMPLE_SIZES = {"quickstart": dict(topos=("pon3",)),
                 "pattern_sweep": dict(n_seeds=2),
                 "failure_sweep": dict(n_seeds=2, presets=("link1",)),
                 "online_arrivals": {}, "coflow_schedule": {},
                 "serve_batch": {},
                 "train_lm": dict(steps=3, d_model=64, n_layers=2)}
EXAMPLE_BACKENDS = {"quickstart": ("pallas", "xla"),
                    "pattern_sweep": ("pallas", "xla"),
                    "failure_sweep": ("pallas", "xla"),
                    "online_arrivals": ("pallas", "xla")}
EXAMPLE_ATOL = 1e-9                  # a value of 0 beside float noise
# train_lm: a loss on the card against the host's from the same weights
# (tests/test_torch_train.py's bound).  At the smoke width and 2 layers:
# at the example's own 8 layers the gradient is dominated by rounding
# (tests/test_torch_examples.py), so the card and the host part after
# the first step
TRAIN_LOSS_TOL = 2e-2
# serve_batch: a greedy token is exact where its logit leads the next by
# more than this many bf16 places of its own value
GREEDY_EXACT_PLACES = 4
# a helper process's time limit, from its start
HELPER_TIMEOUT_S = 900


def host_staged():
    """A dispatch mode for a gloo world whose ranks share the card:
    inside it, each collective of SHARDED_STAGED that gets CUDA tensors
    runs on pinned host copies of them instead, and its result is copied
    back to the card (as ops.ShardGather stages the sharded solve's
    all_gather).  DTensor ops are passed on, so the collectives DTensor
    issues inside them come back to the mode.  An all-gather over a group
    of one rank is a copy on the card.  `calls` counts the staged
    collectives and `seconds` their host time, the copies included."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    staged = {getattr(getattr(getattr(torch.ops, ns), op), overload)
              for ns, op, overload in (n.split(".") for n in SHARDED_STAGED)}
    gather = torch.ops._c10d_functional.all_gather_into_tensor.default

    class HostStaged(TorchDispatchMode):
        ops = staged

        def __init__(self):
            super().__init__()
            self.calls = 0
            self.seconds = 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                # DTensor runs the op as local ops and collectives, which
                # come back here while this mode stays active
                return NotImplemented
            if func not in self.ops or not args[0].is_cuda:
                return func(*args, **kwargs)
            if func is gather and args[1] == 1:
                return args[0].clone()
            t0 = time.perf_counter()
            device = args[0].device
            host = [torch.empty(a.shape, dtype=a.dtype,
                                pin_memory=True).copy_(a)
                    if isinstance(a, torch.Tensor) and a.is_cuda else a
                    for a in args]
            out = torch.ops._c10d_functional.wait_tensor.default(
                func(*host, **kwargs)).to(device)
            self.calls += 1
            self.seconds += time.perf_counter() - t0
            return out
    return HostStaged()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# the phase whose lines say() prints, since when, and each phase's wall
# so far: a line opening with "[N]" starts phase N's clock (a phase that
# comes back, as 26-27 and 28-29 alternate, adds to its wall)
_PHASE = {"label": None, "t": 0.0}
PHASE_WALLS: dict[str, float] = {}


def phase_clock(label: str | None) -> None:
    """Stop the running phase's clock (printing its wall line) and start
    `label`'s; None stops it alone."""
    now = time.perf_counter()
    prev = _PHASE["label"]
    if prev == label:
        return
    if prev is not None:
        spent = now - _PHASE["t"]
        PHASE_WALLS[prev] = PHASE_WALLS.get(prev, 0.0) + spent
        print(f"    wall: phase {prev} {spent:.1f} s", flush=True)
    _PHASE.update(label=label, t=now)


def say(*a):
    m = re.match(r"\[(\d+)\]", str(a[0])) if a else None
    if m:
        phase_clock(m.group(1))
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
    from repro_torch.core import solver
    xmax = np.where(np.isfinite(lp.xmax), lp.xmax, 1e12)
    cscale = max(float(np.abs(lp.c).max(initial=0.0)), 1e-12)
    op, vecs, ell = solver._pack_ell(lp.c / cscale, lp.row, lp.col, lp.val,
                                     lp.b, lp.h, xmax, lp.m_eq, dev)
    return op, vecs + random_start(lp, xmax, op.n_pad, op.m_pad, dev, ell)


def random_start(lp, xmax, n_pad, m_pad, dev, ell) -> tuple:
    """No coordinate frozen, the tables `ell`, and a seeded start inside
    the box: the burst operands after the vectors."""
    import numpy as np
    import torch
    keep = (torch.zeros(n_pad, dtype=torch.bool, device=dev),
            torch.zeros(m_pad, dtype=torch.bool, device=dev))
    rng = np.random.default_rng(0)
    x0 = np.zeros(n_pad, np.float32)
    x0[:lp.n] = rng.uniform(0.0, 1.0, lp.n) * np.minimum(xmax, 1.0)
    y0 = np.zeros(m_pad, np.float32)
    y0[:lp.m] = rng.normal(0.0, 0.1, lp.m)
    start = (torch.from_numpy(x0).to(dev), torch.from_numpy(y0).to(dev))
    return keep + ell + start


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
    torch.profiler's device activity: {name: (launches, total
    microseconds)}, or None when the profiler reports no device time.
    The device events are read off the trace as the profiler recorded
    them (`kineto_results`): building its per-op tables takes a minute
    or more for a call of 300,000 kernels, such as xlstm's prefill."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue          # the host's runtime calls
        us = e.duration_ns() * 1e-3
        if us > 0:
            name = e.name().replace("(anonymous namespace)::", "")
            if not name.startswith(("Memcpy", "Memset")):
                name = name.split("(")[0].strip()[:60]   # drop signature
            c0, us0 = out.get(name, (0, 0.0))
            out[name] = (c0 + 1, us0 + us)
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
    res = solver.solve_lp(lp, backend="pallas", device=dev)
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
    solver.solve_fast(p, "energy", backend="pallas", device=dev)
    wall = time.perf_counter() - t0
    before = ops.PDHG_BURST_LAUNCHES
    busy = profile_device(lambda: solver.solve_fast(p, "energy",
                                                    backend="pallas",
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
                            patterns=(pat,), seeds=(seed,),
                            backend="pallas", device="cpu")
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


def attention_layout_probe(dev) -> list[str]:
    """The bf16 kernel on structured inputs (B = 1, one head, S = T = 256)
    at each padded head dim of its tile plan, before the full cases, with
    the two products' layouts reported apart:
      O = P V: q = 0 under the causal mask, so every score is 0 whatever
        S's layout and row i weighs keys 0..i alike; v random, so out[i] =
        mean(v[:i+1]), which a wrong P register layout, V descriptor or O
        fragment moves;
      S = Q K^T: no mask, q row i = 8 sqrt(hd) e_(i mod hd) and k row j =
        e_(j mod hd), so row i favours the keys j = i (mod hd) by e^8; v
        row j = j / 256 in every column, so out[i] says which keys won,
        which a wrong Q or K descriptor moves.
    Each is held to the plain version within FA_TOL; the worst element's
    row and column are printed.  Returns the failures, "S" or "O" with
    the head dim."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa
    bad = []
    n = 256
    for hd in sorted({fa.tile_plan(d).hdp for d in range(8, 257, 8)}):
        g = torch.Generator(device=dev).manual_seed(hd)
        i = torch.arange(n, device=dev)
        eye = torch.nn.functional.one_hot(i % hd, hd).float()
        cases = {
            "O": (torch.zeros(1, n, 1, hd, device=dev),
                  torch.randn(1, n, 1, hd, generator=g, device=dev),
                  torch.randn(1, n, 1, hd, generator=g, device=dev), True),
            "S": ((8 * hd ** 0.5 * eye)[None, :, None],
                  eye[None, :, None],
                  (i.float() / n)[None, :, None, None].expand(1, n, 1, hd)
                  .contiguous(), False),
        }
        for what, (q, k, v, causal) in cases.items():
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
            got = ops.flash_attention(q, k, v, causal=causal)
            want = fa_plain(q, k, v, 0, 0.0, causal)
            torch.cuda.synchronize()
            atol, rtol = FA_TOL["bfloat16"]
            rel = ((got.float() - want.float()).abs()
                   / (atol + rtol * want.float().abs()))[0, :, 0]
            worst = int(rel.argmax())
            row, col = divmod(worst, hd)
            ok = bool(torch.isfinite(got).all()) and float(rel.max()) <= 1.0
            say(f"    layout probe hd {hd}, {what} = "
                f"{'P V' if what == 'O' else 'Q K^T'}: "
                f"{'ok' if ok else 'WRONG'}; worst |kernel-plain|/limit "
                f"{float(rel.max()):.3f} at row {row}, column {col} (kernel "
                f"{float(got[0, row, 0, col]):.5g}, plain "
                f"{float(want[0, row, 0, col]):.5g})")
            if not ok:
                bad.append(f"{what} at hd {hd}")
    return bad


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


def attention_misaligned(dev) -> int:
    """Phase 8's alignment case: q, k and v as contiguous views 4 bytes
    past a 16-byte boundary (the wrapper copies them onto one,
    ops._aligned16) at FA_MISALIGNED's causal GQA shape, in each dtype:
    finite and bitwise the same call on aligned copies.  Returns the
    launches, two a dtype."""
    import torch
    from repro_torch.kernels import ops
    B, S, H, Hkv, hd = FA_MISALIGNED
    before = ops.FLASH_ATTENTION_LAUNCHES
    for seed, dt in enumerate(FA_DTYPES):
        q, k, v = fa_inputs(100 + seed, B, S, H, Hkv, hd, getattr(torch, dt),
                            dev)
        views = [misaligned(t) for t in (q, k, v)]
        got = ops.flash_attention(*views, causal=True)
        want = ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        say(f"    q, k, v 4 B past a 16-byte boundary ({B}, {S}, {H}/{Hkv}, "
            f"{hd}) {dt}: bitwise the aligned call {same}")
        require(bool(torch.isfinite(got).all()) and same,
                f"misaligned {dt} attention differs from the aligned call")
    return ops.FLASH_ATTENTION_LAUNCHES - before


def setmaxnreg_split() -> tuple[int, int]:
    """(producer, consumer) registers a thread that the bf16 attention
    kernel's setmaxnreg asks for (kProducerRegs, kConsumerRegs in its
    source)."""
    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
                 for n in ("kProducerRegs", "kConsumerRegs"))


def attention_template_counts() -> tuple[int, int]:
    """(bf16, fp32) templates that flash_attention.cu builds: the entries
    of its FA_WGMMA_TEMPLATES and FA_SIMT_TEMPLATES lines."""
    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention.cu").read_text()
    counts = []
    for name in ("FA_WGMMA_TEMPLATES", "FA_SIMT_TEMPLATES"):
        line = re.search(rf"#define {name}\(X\)((?:.*\\\n)*.*)", src)
        counts.append(len(re.findall(r"X\(", line.group(1))))
    return tuple(counts)


def simt_tensor_core_words() -> list[str]:
    """Tensor-core words (mma, wgmma, tf32) in the code of the attention
    kernel's fp32 entry, from its banner to its end marker, comments
    left out: empty when every product and sum is on the FMA units."""
    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention.cu").read_text()
    body = src[src.index("// fp32 entry: the SIMT kernel"):
               src.index("// end of the fp32 entry")]
    code = re.sub(r"//.*", "", body)
    return [w for w in ("mma", "tf32", "TF32") if w in code]


def ptxas_templates(log: str, split: tuple | None = None) -> list[str]:
    """One line per compiled kernel template from nvcc's -Xptxas -v log:
    its name and template arguments, registers (at entry), and spill
    bytes; with `split` (setmaxnreg_split()), the bf16 wgmma templates also
    name the registers their producer and consumers run with."""
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
            regs = (f", setmaxnreg {split[0]} (producer) / {split[1]} "
                    f"(consumers)" if split and "wgmma" in name else "")
            out.append(f"{name}: {m.group(1)} registers{regs}, {spills}")
            name = None
    return out


def fa32_times(card, dev, launches, max_err) -> dict:
    """Phase 10, PERF.md row 2f: the fp32 SIMT entry of the attention
    kernel at phi4-mini's serving shape, beside its plain version and
    torch SDPA in fp32, and its bound at the fp32 rate outside the tensor
    cores (attention_bound_fp32), with the tile plan it ran on.  No model
    path launches it (activations are bf16); `launches` are phase 8's
    grid's and `max_err` its largest |kernel - plain| over the fp32 cases.
    Returns the kernel's entry of the kernels line."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import flash_attention as fa
    shape = (4, 2048, 24, 8, 128)
    q, k, v = fa_inputs(99, *shape[:2], *shape[2:], torch.float32, dev)
    ms = sorted(time_events(lambda: ops.flash_attention(q, k, v), 3)
                for _ in range(3))[1]
    plain_ms = time_events(lambda: fa_plain(q, k, v, 0, 0.0), 1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_events(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True), 3)
    bound_ms, bound_by, nbytes, flop = attention_bound_fp32(*shape, 0)
    del q, k, v, qt, kt, vt
    p = fa.simt_plan(shape[-1])
    say(f"    fp32 SIMT entry (row 2f, q (4, 2048, 24, 128), k/v (4, 2048, "
        f"8, 128), fp32, causal; {card}): {ms:.6f} ms a launch (median of "
        f"3 runs of 3); plain {plain_ms:.6f} ms; SDPA in fp32 "
        f"{lib_ms:.6f} ms; bound {bound_ms:.6f} ms ({bound_by}: {flop} "
        f"flop at 67 TFLOP/s fp32, {nbytes} B at 3.35 TB/s); "
        f"{ms / bound_ms:.3f}x its bound, {ms / lib_ms:.3f}x SDPA; "
        f"launches: {launches} in phase 8's grid, none on a model path")
    say(f"    its plan (kernels/flash_attention.py::simt_plan): "
        f"flash_fwd_simt<{p.hdp}, {p.bq}, {p.bkv}, {p.stages}>, {p.threads} "
        f"threads, {p.smem} B of shared memory a block")
    return {"name": "flash_attention_f32", "route": "cuda",
            "source": FA_SOURCE, "replaces": FA_REPLACES,
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def attention_bound_fp32(B, S, H, Hkv, hd, window):
    """attention_bound for fp32 operands, whose products run on the FMA
    units: the same flop at the fp32 rate outside the tensor cores
    (FP32_OPS_S), against the fp32 bytes at the HBM rate.  Returns (ms,
    bound_by, bytes, flop)."""
    _, _, nbytes, flop = attention_bound(B, S, H, Hkv, hd, window, 4)
    t_ops, t_bytes = flop / FP32_OPS_S * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else
            "bytes", nbytes, flop)


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


def misaligned(t):
    """A contiguous copy of `t` (4-byte or 2-byte elements) that starts 4
    bytes past a 16-byte boundary."""
    import torch
    size = t.element_size()
    flat = torch.empty(t.numel() + 16 // size, dtype=t.dtype,
                       device=t.device)
    skip = (4 - flat.data_ptr()) % 16 // size
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


def compare_sublayers(label, model, batch) -> float:
    """sublayer_excess in every attention and recurrent layer, on the
    hidden state of the kernel path (from a prefill batch: the tokens, and
    an encoder-decoder model's frames or a VLM's image embeddings);
    requires it at most 1 everywhere, and above 1 in the first layer of
    each kind when its kernel is replaced by a broken one (an attention
    that drops the last kv tile, a scan that drops the last step), so the
    check can fail.  xLSTM layers run their kernel-free path unchecked.
    Returns the worst ratio."""
    import torch
    from repro_torch.models import transformer
    worst, broken, count = {}, {}, {}
    with torch.no_grad():
        x, memory = transformer._inputs(model, batch)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        for i, block in enumerate(model.blocks):
            if block.kind not in ("mlstm", "slstm"):
                kind = "rglru" if block.kind == "rglru" else "attention"
                count[kind] = count.get(kind, 0) + 1
                if kind not in broken:
                    broken[kind] = (i, sublayer_excess(
                        block, x, pos, scan_drop_last_step if kind == "rglru"
                        else fa_drop_last_tile))
                worst[kind] = max(worst.get(kind, 0.0),
                                  sublayer_excess(block, x, pos))
            x = block(x, pos, mode="train", impl="kernel", memory=memory)[0]
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


# ---------------------------------------------------------------------------
# phases 19-22: failures and warm re-solves, online arrivals, chaos, the
# sweep's new axes
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording(mod, name):
    """While the block runs, append each call's (args, kwargs) of
    `mod.name` to the list it yields, and call through."""
    calls = []
    fn = getattr(mod, name)

    def rec(*a, **kw):
        calls.append((a, kw))
        return fn(*a, **kw)

    with mock.patch.object(mod, name, rec):
        yield calls


def warm_stack_args(lps, starts, dev):
    """The burst's operands for a warm-started stack exactly as
    solve_lp_batch hands them over: the block-stacked LP packed in
    blocked ELL, nothing frozen, and the projected float64 starts cast to
    float32 ([equalities; inequalities] for y).  Returns (op, args)."""
    import numpy as np
    import torch
    from repro_torch.core import solver
    g = solver.block_stack(lps).lp
    op, vecs, ell = solver._pack_ell(g.c, g.row, g.col, g.val, g.b, g.h,
                                     g.xmax, g.m_eq, dev)
    x0 = np.concatenate([s[0] for s in starts])
    y0 = np.concatenate([s[1][:lp.m_eq] for s, lp in zip(starts, lps)]
                        + [s[1][lp.m_eq:] for s, lp in zip(starts, lps)])
    keep = (torch.zeros(op.n_pad, dtype=torch.bool, device=dev),
            torch.zeros(op.m_pad, dtype=torch.bool, device=dev))
    start = tuple(torch.from_numpy(np.pad(np.asarray(v, np.float32),
                                          (0, pad - len(v)))).to(dev)
                  for v, pad in ((x0, op.n_pad), (y0, op.m_pad)))
    return g, op, vecs + keep + ell + start


def csr_pair_ms(lp, dev) -> float:
    """The library yardstick: one torch CSR mat-vec each way (cuSPARSE),
    the sparse work of one PDHG iteration; the port never calls it."""
    import numpy as np
    import torch
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # CSR is beta
        K = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([lp.row, lp.col])),
            torch.from_numpy(lp.val.astype(np.float32)), (lp.m, lp.n),
            check_invariants=True).coalesce()
        Kc = K.to_sparse_csr().to(dev)
        KTc = K.t().coalesce().to_sparse_csr().to(dev)
    xv = torch.rand(lp.n, 1, device=dev)
    yv = torch.rand(lp.m, 1, device=dev)
    return time_events(lambda: (Kc @ xv, KTc @ yv), 200)


def failure_phase(probs8, healthy, dev, sms, bf16_presets) -> dict:
    """Phase 19: the healthy 8-stack's first FAIL_MEMBERS[preset] members
    degraded under each of FAIL_PRESETS, re-solved warm
    (solve_fast_ensemble(warm=healthy)) and cold on the card; bf16
    storage for `bf16_presets`; the warm burst held to its
    summation-order model from the projected start; the burst timed at
    the warm degraded stack.  Returns the launch counts of the warm,
    cold and bf16 ensembles and the times of row 1d."""
    import numpy as np
    from repro_torch.core import failures, solver, verify
    from repro_torch.kernels import ops, pdhg_spmv
    out = {"launches": 0, "bf16_launches": 0}
    stages = (("projection (project_warm_start)", solver,
               "project_warm_start"),) + batch_stages()
    for preset in FAIL_PRESETS:
        members = FAIL_MEMBERS[preset]
        healthy_k = healthy[:members]
        t0 = time.perf_counter()
        dprobs = [failures.degrade_problem(
            p, failures.sample(p.topo, preset, seed))
            for seed, p in zip(BATCH_SEEDS, probs8[:members])]
        t_degrade = time.perf_counter() - t0
        keys = {solver._structure_key(q, "energy") for q in dprobs}
        lost = [failures.degradation_ratio(p.topo, q.topo)
                for p, q in zip(probs8, dprobs)]
        say(f"    {preset}: {len(dprobs)} degraded problems in {t_degrade:.3f} s; "
            f"capacity lost {min(lost):.4f}..{max(lost):.4f}; offered "
            f"{min(q.coflow.total_gbits for q in dprobs):.1f}.."
            f"{max(q.coflow.total_gbits for q in dprobs):.1f} Gbit of 120; "
            f"{len(keys)} distinct sparsity patterns among them")
        require(len(keys) > 1, f"{preset}: the degraded members share one "
                               f"sparsity pattern")
        snap = solver.build_cache_stats().snapshot()
        ops.PDHG_BURST_LAUNCHES = 0
        ops.PDHG_ADAPTIVE_CALLS = 0
        with recording(solver, "solve_lp_batch") as calls, \
                stage_clock(stages) as spent:
            t0 = time.perf_counter()
            warm = solver.solve_fast_ensemble(dprobs, "energy",
                                              warm=healthy_k,
                                              backend="pallas", device=dev)
            warm_wall = time.perf_counter() - t0
        warm_launches = ops.PDHG_BURST_LAUNCHES
        warm_calls = ops.PDHG_ADAPTIVE_CALLS
        d = solver.build_cache_stats()
        ops.PDHG_BURST_LAUNCHES = 0
        with stage_clock(stages) as cold_spent:
            t0 = time.perf_counter()
            cold = solver.solve_fast_ensemble(dprobs, "energy",
                                              backend="pallas", device=dev)
            cold_wall = time.perf_counter() - t0
        cold_launches = ops.PDHG_BURST_LAUNCHES
        out["launches"] += warm_launches + cold_launches
        say(f"    {preset}: warm ensemble wall {warm_wall:.3f} s "
            f"({warm_calls} pdhg_adaptive calls, {warm_launches} bursts, "
            f"chunk {calls[0][1]['chunk']}; ELL plans built "
            f"{d.ell_misses - snap.ell_misses}, LP structures built "
            f"{d.structure_misses - snap.structure_misses}); cold "
            f"{cold_wall:.3f} s ({cold_launches} bursts)")
        for label, sec in spent.items():
            say(f"        stage {label}: {sec:.4f} s "
                f"({sec / warm_wall:.4f} of the wall; cold "
                f"{cold_spent[label]:.4f} s)")
        say(f"        decomposed paths: warm {sum(len(w.paths) for w in warm)}"
            f", cold {sum(len(c.paths) for c in cold)}")
        require(calls[0][1]["chunk"] == 250, "the warm ensemble's chunk "
                                             "is not 250")
        for seed, q, w, c in zip(BATCH_SEEDS, dprobs, warm, cold):
            verify.check_schedule(q, w.schedule).assert_ok(
                f"{preset} seed {seed} warm")
            verify.check_schedule(q, c.schedule).assert_ok(
                f"{preset} seed {seed} cold")
            sw, sc = float(w.metrics.served.sum()), float(c.metrics.served.sum())
            dE = rel_diff(w.metrics.energy_j, c.metrics.energy_j)
            say(f"      seed {seed}: warm E={w.metrics.energy_j:.6f} J "
                f"served {sw:.6f} iters {w.iterations} | cold "
                f"E={c.metrics.energy_j:.6f} J served {sc:.6f} iters "
                f"{c.iterations} | dE {dE:.2e}; certified")
            require(rel_diff(sw, sc) <= WARM_SERVED_RTOL,
                    f"{preset} seed {seed}: warm serves {sw}, cold {sc}")
            require(dE <= WARM_ENERGY_BAND,
                    f"{preset} seed {seed}: warm energy {dE:.3e} off cold")
        w_it = sum(w.iterations for w in warm)
        c_it = sum(c.iterations for c in cold)
        say(f"    {preset}: iterations warm {w_it} against cold {c_it}")
        require(w_it < c_it, f"{preset}: warm iterations {w_it} not below "
                             f"cold {c_it}")
        # the warm dispatch again, and each member alone (its solo
        # solve_fast_warm's LP solve): bitwise
        lps, kw = calls[0][0][0], calls[0][1]
        starts = kw["warm_starts"]
        again = solver.solve_lp_batch(lps, chunk=250, warm_starts=starts,
                                      backend="pallas", device=dev)
        require(all(np.array_equal(a.x, w.lp_x) and np.array_equal(a.y, w.lp_y)
                    and a.iterations == w.iterations
                    for a, w in zip(again, warm)),
                f"{preset}: two warm runs differ")
        solo_same = []
        for lp, st, w in zip(lps, starts, warm):
            s = solver.solve_lp_batch([lp], chunk=250, warm_starts=[st],
                                      backend="pallas", device=dev)[0]
            solo_same.append(np.array_equal(s.x, w.lp_x)
                             and np.array_equal(s.y, w.lp_y)
                             and s.iterations == w.iterations)
        say(f"    {preset}: the warm dispatch run again: bitwise equal; "
            f"each member alone from its projected start: bitwise equal "
            f"for {sum(solo_same)} of {len(solo_same)}")
        require(all(solo_same), f"{preset}: a stacked member differs from "
                                f"its solo solve")
        if preset in bf16_presets:
            ops.PDHG_BURST_BF16_LAUNCHES = 0
            t0 = time.perf_counter()
            bf = solver.solve_fast_ensemble(dprobs, "energy", warm=healthy_k,
                                            precision="bf16",
                                            backend="pallas", device=dev)
            bf_wall = time.perf_counter() - t0
            out["bf16_launches"] += ops.PDHG_BURST_BF16_LAUNCHES
            for seed, q, b in zip(BATCH_SEEDS, dprobs, bf):
                verify.check_schedule(q, b.schedule).assert_ok(
                    f"{preset} seed {seed} bf16 warm")
            say(f"    {preset}: bf16 warm ensemble wall {bf_wall:.3f} s, "
                f"{ops.PDHG_BURST_BF16_LAUNCHES} bf16 bursts, {len(bf)} schedules "
                f"certified; iterations "
                f"{[b.iterations for b in bf]} (fp32 {[w.iterations for w in warm]})")
        if preset == FAIL_PRESETS[0]:
            x0 = np.concatenate([s[0] for s in starts])
            y0 = np.concatenate([s[1] for s in starts])
            say(f"    {preset}: the projected start has {np.count_nonzero(x0)}"
                f" of {len(x0)} x and {np.count_nonzero(y0)} of {len(y0)} y "
                f"non-zero")
            require(np.count_nonzero(x0) and np.count_nonzero(y0),
                    "the projected start is zero")
            g, op, args = warm_stack_args(lps, starts, dev)
            lay = layout(op, dev)
            for precision in ("fp32", "bf16"):
                for iters in WARM_ORDER_ITERS:
                    k = ops.pdhg_burst(*args, **lay, iters=iters,
                                       precision=precision)
                    check_kernel_order(f"warm {preset} 8-stack", op, args,
                                       iters, precision, k, sms)
            n_k = 1000
            ms = sorted(time_events(lambda: ops.pdhg_burst(
                *args, iters=n_k, **lay), 1) / n_k for _ in range(3))[1]
            plain_ms = time_events(lambda: pdhg_spmv.pdhg_update_burst(
                args[12], args[13], *args[:12], iters=5, **lay), 1) / 5
            library_ms = csr_pair_ms(g, dev)
            bound_ms, bound_by, nbytes, nops = burst_bound(op, len(g.val))
            say(f"    warm {preset} 8-stack: n={g.n} m={g.m} nnz={len(g.val)}; "
                f"ELL n_pad={op.n_pad} m_pad={op.m_pad}")
            say(f"    kernel  {ms:.6f} ms/iter (burst of {n_k}, median of 3)")
            say(f"    plain   {plain_ms:.6f} ms/iter (burst of 5)")
            say(f"    library {library_ms:.6f} ms per K.x + K^T.y pair "
                f"(torch CSR matmul)")
            say(f"    bound   {bound_ms:.6f} ms/iter ({bound_by}: {nbytes} B "
                f"at 3.35 TB/s, {nops} fp32 ops at 67 TFLOP/s)")
            out.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms)
    return out


def epoch_rows(res) -> list[dict]:
    """A run_online result's epochs as dicts, the wall clock left out."""
    return [{k: v for k, v in dataclasses.asdict(e).items()
             if k != "solve_s"} for e in res.epochs]


def online_summary(res) -> dict:
    """What a run_online result reports, epochs and wall clock aside."""
    return {"n_epochs": res.n_epochs, "total_energy_j": res.total_energy_j,
            "makespan_s": res.makespan_s,
            "mean_response_s": res.mean_response_s,
            "backlog_gbits": res.backlog_gbits,
            "total_iterations": res.total_iterations,
            "availability": res.availability,
            "stranded_gbits": res.stranded_gbits,
            "deferred_failure_gbits": res.deferred_failure_gbits,
            "recoveries": list(res.recoveries),
            "chaos_log": list(res.chaos_log),
            "t_done": [c.t_done for c in res.coflows]}


def online_differs(a, b, rtol=METRIC_RTOL) -> list[str]:
    """Where two run_online results differ by more than `rtol` (numbers)
    or at all (anything else)."""
    def off(x, y):
        if isinstance(x, float) and isinstance(y, float):
            if math.isnan(x) or math.isnan(y):
                return not (math.isnan(x) and math.isnan(y))
            return rel_diff(x, y) > rtol and abs(x - y) > 1e-9
        return x != y
    bad = [f"epochs: {a.n_epochs} vs {b.n_epochs}"] \
        if a.n_epochs != b.n_epochs else []
    for i, (ea, eb) in enumerate(zip(epoch_rows(a), epoch_rows(b))):
        bad += [f"epoch {i} {k}: {ea[k]} vs {eb[k]}" for k in ea
                if off(ea[k], eb[k])]
    sa, sb = online_summary(a), online_summary(b)
    for k in sa:
        if isinstance(sa[k], list):
            if len(sa[k]) != len(sb[k]) or any(
                    off(x, y) for x, y in zip(sa[k], sb[k])):
                bad.append(f"{k} differs")
        elif off(sa[k], sb[k]):
            bad.append(f"{k}: {sa[k]} vs {sb[k]}")
    return bad


def online_bitwise(a, b) -> bool:
    """Two run_online results equal in every reported bit but the wall
    clock."""
    return (epoch_rows(a) == epoch_rows(b)
            and repr(online_summary(a)) == repr(online_summary(b)))


def hold_card_to_cpu(label, run, card) -> None:
    """The order rule: the card's result against the same run on the CPU
    (the plain version in torch's order) within METRIC_RTOL; where they
    differ more, the plain version summing each row in the kernel's order
    must reproduce the card's result bitwise."""
    t0 = time.perf_counter()
    cpu = run("cpu")
    bad = online_differs(card, cpu)
    say(f"    {label}: the CPU run ({time.perf_counter() - t0:.1f} s) "
        f"{'agrees within ' + format(METRIC_RTOL, 'g') if not bad else 'differs: ' + '; '.join(bad[:4])}")
    if bad:
        with in_kernel_order():
            ko = run("cpu")
        same = online_bitwise(card, ko)
        say(f"    {label}: the CPU run in the kernel's summation order "
            f"reproduces the card's bitwise: {same}")
        require(same, f"{label}: the card differs from the CPU run and "
                      f"from its kernel-order model: {bad[:4]}")


def report_online(label, res, trace, wall, driver_s) -> None:
    """Epochs, iterations, warm epochs, conservation and the wall split
    of one run_online result; conservation (shipped + backlog + deferred
    = offered to 1e-9) and feasibility are required."""
    offered = sum(a.coflow.total_gbits for a in trace)
    shipped = sum(e.shipped_gbits for e in res.epochs)
    left = shipped + res.backlog_gbits + res.deferred_failure_gbits
    n = max(res.n_epochs, 1)
    say(f"    {label}: {res.n_epochs} epochs ({sum(e.warm for e in res.epochs)}"
        f" warm), {res.total_iterations} iterations (warm epochs "
        f"{res.warm_iterations:.1f} on average), shipped {shipped:.6f} of "
        f"{offered:.6f} Gbit (backlog {res.backlog_gbits:.3e}, deferred "
        f"{res.deferred_failure_gbits:.3e}), E={res.total_energy_j:.3f} J, "
        f"makespan {res.makespan_s:.6f} s, response {res.mean_response_s:.6f} s;"
        f" wall {wall:.3f} s, {wall / n:.3f} s an epoch: adaptive driver "
        f"(bursts, a sync a chunk) {driver_s / n:.3f}, host "
        f"{(wall - driver_s) / n:.3f}")
    require(abs(left - offered) <= 1e-9 * offered,
            f"{label}: {left} Gbit accounted of {offered}")
    require(all(e.feasible for e in res.epochs), f"{label}: an infeasible "
                                                 f"epoch")


def online_phase(dev) -> dict:
    """Phase 20: tests/test_arrivals.py's heavy trace on the card and the
    CPU, its one-epoch case against solve_fast, and the flagship shuffle
    as a poisson trace, warm and cold.  Returns the traces, for phase 21,
    and the launch count."""
    from repro_torch.core import arrivals, solver, timeslot, topology, traffic
    from repro_torch.kernels import ops
    sl = topology.build("spine-leaf")
    heavy = arrivals.generate_trace(
        sl, traffic.pattern("uniform", **HEAVY),
        arrivals.ArrivalSpec(family="poisson", n_coflows=4,
                             mean_interarrival_s=2.0), seed=0)
    launches = 0
    ops.PDHG_BURST_LAUNCHES = 0
    t0 = time.perf_counter()
    card = arrivals.run_online(sl, heavy, "energy", **ONLINE_KW,
                               backend="pallas", device=dev)
    wall = time.perf_counter() - t0
    launches += ops.PDHG_BURST_LAUNCHES
    report_online("spine-leaf heavy trace, card", card, heavy, wall, 0.0)
    require(card.n_epochs > 1 and any(e.warm for e in card.epochs[1:]),
            "the heavy trace did not roll warm")
    hold_card_to_cpu("spine-leaf heavy trace", lambda d: arrivals.run_online(
        sl, heavy, "energy", **ONLINE_KW, backend="pallas", device=d), card)
    # one epoch: all co-flows at t = 0 reproduce solve_fast exactly
    cfs = [traffic.generate(sl, traffic.pattern("uniform", **LIGHT), s)
           for s in range(3)]
    merged = traffic.concat_coflows(cfs, sl.n_vertices)
    p = timeslot.ScheduleProblem(
        sl, merged, n_slots=timeslot.suggest_n_slots(sl, merged),
        path_slack=2)

    def one_epoch(d):
        res = arrivals.run_online(sl, arrivals.trace_at_t0(cfs), "energy",
                                  iters=3000, tol=2e-3,
                                  backend="pallas", device=d)
        ref = solver.solve_fast(p, "energy", iters=3000, tol=2e-3,
                                backend="pallas", device=d)
        return res, ref

    ops.PDHG_BURST_LAUNCHES = 0
    res, ref = one_epoch("cuda")
    launches += ops.PDHG_BURST_LAUNCHES
    got = (res.last_result.metrics.energy_j,
           res.last_result.metrics.completion_s, res.total_energy_j)
    want = (ref.metrics.energy_j, ref.metrics.completion_s,
            ref.metrics.energy_j)
    require(res.n_epochs == 1 and not res.epochs[0].warm
            and res.backlog_gbits == 0.0, "one-epoch run: not one cold "
                                          "epoch that drains")
    say(f"    one epoch (3 co-flows at t = 0) on the card: E, M, total E "
        f"{got}; solve_fast on the card {want}: exact {got == want}")
    if got != want:
        with in_kernel_order():
            kres, kref = one_epoch("cpu")
        same = (kres.last_result.schedule.tobytes()
                == res.last_result.schedule.tobytes()
                and kref.schedule.tobytes() == ref.schedule.tobytes())
        say(f"    the two in the kernel's summation order on the CPU "
            f"reproduce the card's schedules bitwise: {same}")
        require(same, "one-epoch run: the card's difference from solve_fast"
                      " is not its summation order's")
    # the flagship shuffle arriving online
    ft = topology.build(FULL[0], **FULL[1])
    ft_trace = arrivals.generate_trace(
        ft, traffic.pattern("uniform", **FULL[2]),
        arrivals.ArrivalSpec(family="poisson", n_coflows=FT_COFLOWS,
                             mean_interarrival_s=2.0), seed=0)
    say(f"    {ft.name}: {FT_COFLOWS} co-flows of the flagship shuffle "
        f"(cut from the sweep's 5 for time), arriving at "
        f"{[round(a.t_arrive, 6) for a in ft_trace]} s; epochs of "
        f"{FT_ONLINE_KW['epoch_s']} s, shortest paths")
    ft_runs = {}
    for warm in (True, False):
        ops.PDHG_BURST_LAUNCHES = 0
        with stage_clock((("driver", ops, "pdhg_adaptive"),)) as spent:
            t0 = time.perf_counter()
            r = arrivals.run_online(ft, ft_trace, "energy", **FT_ONLINE_KW,
                                    warm=warm, backend="pallas", device=dev)
            wall = time.perf_counter() - t0
        launches += ops.PDHG_BURST_LAUNCHES
        report_online(f"{ft.name}, warm={warm}", r, ft_trace, wall,
                      spent["driver"])
        ft_runs[warm] = r
    w = ft_runs[True]
    require(w.n_epochs >= 3 and any(e.warm for e in w.epochs),
            f"fat-tree trace: {w.n_epochs} epochs, "
            f"{sum(e.warm for e in w.epochs)} warm; needs 3 and 1")
    require(w.backlog_gbits <= 1e-6 and ft_runs[False].backlog_gbits <= 1e-6,
            "fat-tree trace: demand left")
    return {"launches": launches, "heavy": heavy, "ft": ft,
            "ft_trace": ft_trace}


def chaos_phase(traces, dev) -> int:
    """Phase 21: the storm preset replayed over phase 20's traces with the
    "scf" fallback tier (as the reference's chaos cells run it), twice on
    the card (byte-identical chaos logs and event traces), the heavy
    trace also on the CPU under the order rule.  Returns the launch
    count."""
    from repro_torch.core import arrivals, chaos, topology
    from repro_torch.kernels import ops
    sl = topology.build("spine-leaf")
    launches = 0
    cases = (("spine-leaf heavy trace", sl, traces["heavy"], ONLINE_KW,
              STORM_SEEDS["heavy"]),
             (f"{traces['ft'].name} trace", traces["ft"],
              traces["ft_trace"], FT_ONLINE_KW, STORM_SEEDS["ft"]))
    for label, topo, trace, kw, seed in cases:
        runs, texts = [], []
        for rep in range(2):
            events = chaos.generate_preset_events(topo, ("storm",), seed)
            texts.append(chaos.format_trace(events))
            ops.PDHG_BURST_LAUNCHES = 0
            t0 = time.perf_counter()
            r = arrivals.run_online(topo, trace, "energy", **kw,
                                    chaos=events, fallback_policy="scf",
                                    backend="pallas", device=dev)
            wall = time.perf_counter() - t0
            launches += ops.PDHG_BURST_LAUNCHES
            runs.append(r)
            if rep == 0:
                report_online(f"{label} + storm, card", r, trace, wall, 0.0)
        a, b = runs
        say(f"    {label} + storm (seed {seed}): "
            f"{len(texts[0].splitlines())} events, "
            f"{sum(e.chaos_events for e in a.epochs)} applied at epoch "
            f"boundaries, {sum(e.degraded for e in a.epochs)} degraded "
            f"epochs; availability {a.availability:.6f}; stranded "
            f"{a.stranded_gbits:.6f} Gbit, deferred "
            f"{sum(e.deferred_gbits for e in a.epochs):.6f} Gbit (at the end "
            f"{a.deferred_failure_gbits:.6f}); recoveries "
            f"{[round(float(t), 6) for t in a.recoveries]} s; scf fallback "
            f"epochs {sum(' fallback ' in line for line in a.chaos_log)}")
        for line in a.chaos_log:
            say(f"      {line}")
        require(texts[0] == texts[1], f"{label}: two event traces differ")
        require("\n".join(a.chaos_log) == "\n".join(b.chaos_log)
                and online_bitwise(a, b), f"{label}: two card runs differ")
        require(0.0 <= a.availability < 1.0
                and any(e.degraded and e.n_flows for e in a.epochs),
                f"{label}: the storm did not hit an epoch with demand")
        require(all(e.certified for e in a.epochs),
                f"{label}: an epoch's schedule has no ok certificate")
        say(f"    {label} + storm: two card runs byte-identical (chaos log, "
            f"event trace, every epoch); every epoch certified")
        if topo is sl:
            cpu_events = chaos.generate_preset_events(sl, ("storm",), seed)
            require(chaos.format_trace(cpu_events) == texts[0],
                    f"{label}: the CPU run's event trace differs")
            hold_card_to_cpu(f"{label} + storm", lambda d: arrivals.run_online(
                sl, trace, "energy", **kw, chaos=cpu_events,
                fallback_policy="scf", backend="pallas", device=d), a)
    return launches


def run_cli(args) -> tuple[int, str]:
    """python -m repro_torch.sweep in this process: (exit code, stdout)."""
    import io
    from repro_torch.sweep import __main__ as sweep_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = sweep_main.main(args)
        except SystemExit as e:
            rc = e.code
    return rc, buf.getvalue()


def sweep_axes_phase(dev) -> int:
    """Phase 22: the sweep's --failures, --arrivals and --chaos axes on
    the card, row by row against the CPU under the order rule, and the
    chaos axis's event-trace log; plan_collectives on the card and the
    CPU.  Returns the launch count."""
    import numpy as np
    from repro_torch.core import fabric
    from repro_torch.kernels import ops
    launches = 0
    axes = ((SWEEP_FAILURES_ARGS, "Degraded fabrics", 2),
            (SWEEP_ARRIVALS_ARGS, "Online arrivals", 4),
            (SWEEP_CHAOS_ARGS, "Availability under chaos", 2))
    for args, table, n_flag in axes:
        with tempfile.TemporaryDirectory() as tmp:
            ops.PDHG_BURST_LAUNCHES = 0
            t0 = time.perf_counter()
            rc, text = run_cli(args + ["--out", tmp])
            wall = time.perf_counter() - t0
            launches += ops.PDHG_BURST_LAUNCHES
            card_rows = list(csv.DictReader(open(pathlib.Path(tmp)
                                                 / "results.csv")))
            md = (pathlib.Path(tmp) / "results.md").read_text()
            events_log = pathlib.Path(tmp) / "chaos_events.log"
            events_text = (events_log.read_text() if events_log.exists()
                           else None)
        last = text.strip().splitlines()[-1]
        say(f"    {' '.join(args[-n_flag:])}: exit {rc}, {len(card_rows)} "
            f"rows, {wall:.1f} s: {last}")
        require(rc == 0 and "(0 infeasible)" in last,
                f"sweep {args[-n_flag:]}: exit {rc}")
        require(table in md, f"sweep {args[-n_flag:]}: the table is missing")
        if args is SWEEP_CHAOS_ARGS:
            require(events_text is not None and events_text.startswith(
                "# topo=spine-leaf chaos=storm seed=0\n")
                and " fail " in events_text,
                "--chaos storm: chaos_events.log missing or empty")
            say(f"      chaos_events.log: "
                f"{len(events_text.splitlines())} lines")

        def cpu_rows():
            with tempfile.TemporaryDirectory() as tmp:
                rc, _ = run_cli(args + ["--device", "cpu", "--out", tmp])
                require(rc == 0, "sweep on the CPU failed")
                return list(csv.DictReader(open(pathlib.Path(tmp)
                                                / "results.csv")))

        def differs(rows):
            return [(i, c) for i, (a, b) in enumerate(zip(card_rows, rows))
                    for c in SWEEP_ROW_COLS
                    if (math.isnan(float(a[c])) != math.isnan(float(b[c])))
                    or (not math.isnan(float(a[c]))
                        and rel_diff(float(a[c]), float(b[c])) > METRIC_RTOL
                        and abs(float(a[c]) - float(b[c])) > 1e-9)]

        bad = differs(cpu_rows())
        say(f"      against the same run on the CPU: "
            f"{'every row within ' + format(METRIC_RTOL, 'g') if not bad else 'differs at ' + str(bad)}")
        if bad:
            with in_kernel_order():
                ko = cpu_rows()
            same = all({k: v for k, v in a.items() if k != "solve_s"}
                       == {k: v for k, v in b.items() if k != "solve_s"}
                       for a, b in zip(card_rows, ko))
            say(f"      in the kernel's summation order the CPU reproduces "
                f"the card's rows bitwise: {same}")
            require(same, f"sweep {args[-n_flag:]}: card and CPU rows "
                          f"differ")
    layers = [(f"l{i}", 50e6) for i in range(16)]
    buckets = fabric.grad_buckets_for(layers, bucket_bytes=100e6,
                                      data_axes=(0, 1))
    # the plan solves in the default lowering (xla): the COO kernel
    ops.PDHG_BURST_LAUNCHES = 0
    coo_before = ops.PDHG_COO_LAUNCHES
    plan = fabric.plan_collectives(fabric.v5e_fabric(), buckets,
                                   n_slots=10, device=dev)
    plan_coo = ops.PDHG_COO_LAUNCHES - coo_before
    require(plan_coo > 0 and ops.PDHG_BURST_LAUNCHES == 0,
            f"plan_collectives: {plan_coo} COO and "
            f"{ops.PDHG_BURST_LAUNCHES} ELL bursts; the default lowering "
            f"launches the COO kernel alone")
    cpu = fabric.plan_collectives(fabric.v5e_fabric(), buckets, n_slots=10,
                                  device="cpu")
    d_share = float(np.abs(plan.share - cpu.share).max())
    say(f"    plan_collectives(v5e_fabric(), {len(buckets)} buckets), the "
        f"default lowering ({plan_coo} COO bursts): card completion "
        f"{plan.completion_s:.9f} s, energy {plan.energy_j:.9f} J; CPU "
        f"{cpu.completion_s:.9f} s, {cpu.energy_j:.9f} J; max share "
        f"difference {d_share:.3e} (bitwise "
        f"{np.array_equal(plan.share, cpu.share)}); slot order "
        f"{plan.slot_order()}")
    require(plan.n_slots == cpu.n_slots and d_share <= METRIC_RTOL
            and rel_diff(plan.completion_s, cpu.completion_s) <= METRIC_RTOL
            and rel_diff(plan.energy_j, cpu.energy_j) <= METRIC_RTOL,
            "plan_collectives: card and CPU plans differ")
    return launches


# ---------------------------------------------------------------------------
# phases 23-25: baseline policies, placement search, the service
# ---------------------------------------------------------------------------

def fresh(p):
    """An equal problem that shares no memo with `p` (policies memoise
    their path sets on the instance)."""
    from repro_torch.core import timeslot
    return timeslot.ScheduleProblem(p.topo, p.coflow, n_slots=p.n_slots,
                                    rho=p.rho, q_weight=p.q_weight,
                                    path_slack=p.path_slack)


def policy_phase(dev, p_full, full_lp, full_lp_s) -> int:
    """Phase 23: the golden policy grid on the card against its pins,
    then policy_bench's default cells and the flagship: all five
    policies, certified, gap >= 1 - 1e-4 against the LP of the same
    problem (the flagship's from phase 5), the heuristics bitwise their
    CPU run, each policy's wall beside the LP solve's.  Returns the
    launch count."""
    from repro_torch.core import policies, solver
    from repro_torch.kernels import ops
    golden = json.loads(GOLDEN.read_text())
    launches, worst = 0, (-1.0, "")
    for name in GOLDEN_TOPOS:
        for obj in OBJECTIVES:
            p_lp = problem(name, {}, GOLDEN_PATTERN, 2)
            ops.PDHG_BURST_LAUNCHES = 0
            lp = solver.solve_fast(p_lp, obj, backend="pallas", device=dev)
            launches += ops.PDHG_BURST_LAUNCHES
            for pol in GOLDEN_POLICIES:
                p = problem(name, {}, GOLDEN_PATTERN, 2)
                r = policies.get(pol).solve(p, obj, device=dev)
                r.certificate.assert_ok(f"policy {pol}/{name}/{obj}")
                gap = policies.gap_vs_lp(obj, p, r.schedule, p_lp, lp)
                want = golden[f"policy/{name}/min-{obj}/{pol}/seed0"]
                d = rel_diff(gap, want["gap_vs_lp"])
                worst = max(worst, (d, f"{pol}/{name}/{obj}"))
                require(gap >= 1.0 - 1e-4 and d <= GAP_RTOL
                        and all(math.isclose(getattr(r.metrics, k), want[k],
                                             rel_tol=METRIC_RTOL,
                                             abs_tol=1e-9)
                                for k in ("energy_j", "completion_s")),
                        f"policy {pol}/{name}/{obj}: gap {gap} E "
                        f"{r.metrics.energy_j} M {r.metrics.completion_s} "
                        f"vs pin {want}")
    say(f"    golden policy grid ({len(GOLDEN_TOPOS) * len(OBJECTIVES) * len(GOLDEN_POLICIES)}"
        f" cells): every pin held (metrics within {METRIC_RTOL:g}, gaps "
        f"within {GAP_RTOL:g}; worst gap {worst[0]:.3e} at {worst[1]}); "
        f"every schedule certified")
    cells = [(f"{n} 10x6 30 Gbit", problem(n, {}, POLICY_BENCH_PATTERN, 2),
              None, None) for n in ("spine-leaf", "pon3")]
    cells.append(("fat-tree k=16 flagship (phase 5's LP)", p_full,
                  full_lp, full_lp_s))
    for label, p, lp, lp_s in cells:
        if lp is None:
            ops.PDHG_BURST_LAUNCHES = 0
            t0 = time.perf_counter()
            lp = solver.solve_fast(p, "energy", iters=3000,
                                   backend="pallas", device=dev)
            lp_s = time.perf_counter() - t0
            launches += ops.PDHG_BURST_LAUNCHES
        parts = []
        for pol in policies.POLICIES:
            ops.PDHG_BURST_LAUNCHES = 0
            t0 = time.perf_counter()
            r = policies.get(pol).solve(p, "energy",
                                        backend="pallas", device=dev)
            wall = time.perf_counter() - t0
            n = ops.PDHG_BURST_LAUNCHES
            launches += n
            r.certificate.assert_ok(f"policy {pol}/{label}")
            gap = policies.gap_vs_lp("energy", p, r.schedule, p, lp)
            require(gap >= 1.0 - 1e-4 and r.remaining_gbits <= 1e-6,
                    f"policy {pol}/{label}: gap {gap}, remaining "
                    f"{r.remaining_gbits}")
            same = ""
            if pol != "fair-lp":
                require(n == 0, f"{pol} launched the kernel")
                c = policies.get(pol).solve(fresh(p), "energy", device="cpu")
                require(c.schedule.tobytes() == r.schedule.tobytes()
                        and c.lp_x.tobytes() == r.lp_x.tobytes()
                        and c.metrics.energy_j == r.metrics.energy_j,
                        f"policy {pol}/{label}: card and CPU differ")
                same = ", bitwise the CPU's"
            parts.append(f"{pol} {wall:.3f} s gap {gap:.4f}"
                         f"{' (' + str(n) + ' bursts)' if n else ''}{same}")
        say(f"    {label}: LP {lp_s:.3f} s (E={lp.metrics.energy_j:.3f} J); "
            + "; ".join(parts) + "; every schedule certified")
    return launches


@contextlib.contextmanager
def trajectory():
    """While the block runs, append each placement-search dispatch's
    candidates, as (mappers, reducers, score) tuples, to the list it
    yields."""
    from repro_torch.search import optimize
    calls, real = [], optimize.evaluate_placements

    def rec(*a, **kw):
        out = real(*a, **kw)
        calls.append([(c.placement.mappers.tolist(),
                       c.placement.reducers.tolist(), c.score) for c in out])
        return out

    with mock.patch.object(optimize, "evaluate_placements", rec):
        yield calls


def search_summary(res) -> dict:
    from repro_torch import convert
    d = convert.search_result_to_arrays(res)
    for c in [d["best"], *d["baselines"].values()]:
        c["mappers"], c["reducers"] = (c["mappers"].tolist(),
                                       c["reducers"].tolist())
    return d


def search_matches(a: dict, b: dict, rtol=METRIC_RTOL) -> list[str]:
    """Where two search summaries differ: placements, names and counts
    exactly, scores, gain and history within `rtol`."""
    bad = []
    for key in ("baseline_best", "evaluations", "dispatches"):
        if a[key] != b[key]:
            bad.append(f"{key}: {a[key]} vs {b[key]}")
    pairs = [("best", a["best"], b["best"])] + [
        (k, a["baselines"][k], b["baselines"][k]) for k in a["baselines"]]
    for k, x, y in pairs:
        if (x["mappers"], x["reducers"]) != (y["mappers"], y["reducers"]):
            bad.append(f"{k} placement: {x['mappers']}/{x['reducers']} vs "
                       f"{y['mappers']}/{y['reducers']}")
        if rel_diff(x["score"], y["score"]) > rtol:
            bad.append(f"{k} score: {x['score']} vs {y['score']}")
    if rel_diff(a["gain"], b["gain"]) > rtol:
        bad.append(f"gain: {a['gain']} vs {b['gain']}")
    return bad


def placement_cpu_cell(spec: str) -> int:
    """The --placement-cpu mode: rows of the committed placement run
    re-derived on the host CPU, TOPO:OBJECTIVE:METHOD:SEED:OUT[:kernel]
    (METHOD "none": the LP rows of that seed), written to OUT/results.csv;
    with :kernel the burst's plain version sums each row in the kernel's
    order."""
    import torch
    from repro_torch.core import topology
    from repro_torch.sweep import report, runner
    torch.set_num_threads(1)
    topo, obj, method, seed, out, *order = spec.split(":")
    # PLACEMENT_ARGS' cell, one seed of it
    sw = runner.SweepSpec(topos=(topo,), objectives=(obj,),
                          patterns=("uniform",), seeds=(int(seed),),
                          n_map=6, n_reduce=4, total_gbits=20.0,
                          backend="pallas", device="cpu")
    records, problems = [], []
    with (in_kernel_order() if order == ["kernel"]
          else contextlib.nullcontext()):
        if method == "none":
            records, _ = runner.run_sweep(sw)
        else:
            runner._placement_records(records, problems, sw,
                                      lambda _: None, topo,
                                      topology.build(topo), obj, method)
    report.write_csv(records, pathlib.Path(out) / "results.csv")
    return 0


def cpu_placement_rows(searches) -> dict:
    """Re-derive the named searches (topo, objective, method, seed;
    method "none": the LP rows) on the host CPU in torch's and in the
    kernel's summation order, each in a process of this script's own
    (--placement-cpu), PLACEMENT_CPU_WORKERS at a time.  Returns
    {order: {row key: row}}."""
    import os
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    procs: list[subprocess.Popen] = []

    def run(spec):
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--placement-cpu",
             spec], env=env, cwd=str(ROOT), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        procs.append(proc)
        _, err = proc.communicate()
        require(proc.returncode == 0, f"--placement-cpu {spec}: exit "
                                      f"{proc.returncode}: {err[-2000:]}")

    out = {"torch": {}, "kernel": {}}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for i, (topo, obj, method, seed) in enumerate(searches):
            for order in out:
                d = pathlib.Path(tmp) / f"{i}-{order}"
                spec = f"{topo}:{obj}:{method}:{seed}:{d}" + (
                    ":kernel" if order == "kernel" else "")
                jobs.append((order, d, spec))
        pool = ThreadPoolExecutor(PLACEMENT_CPU_WORKERS)
        try:
            list(pool.map(run, [spec for _, _, spec in jobs]))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
            pool.shutdown(wait=True, cancel_futures=True)
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        for order, d, _ in jobs:
            out[order].update(placement_rows(d / "results.csv"))
    return out


def placement_rows(path) -> dict:
    """results.csv rows keyed (topo, objective, pattern, seed,
    placement_search)."""
    with open(path, newline="") as fh:
        return {(r["topo"], r["objective"], r["pattern"], int(r["seed"]),
                 r["placement_search"]): r for r in csv.DictReader(fh)}


def placement_row_diff(a: dict, b: dict) -> float:
    return max(rel_diff(float(a[c]), float(b[c]))
               for c in ("energy_j", "completion_s", "placement_gain"))


def placement_phase(dev) -> dict:
    """Phase 24: the pinned SA runs twice on the card (identical
    trajectories) against their pins or, where the port's CPU run misses
    a pin too, against that CPU run; the committed placement run against
    results/placement/results.csv under phase 14's rule; evaluations a
    second, dispatches, and the stage clock of one generation.  Returns
    the launch count and the rates."""
    import numpy as np
    from repro_torch import search
    from repro_torch.core import topology, traffic
    from repro_torch.kernels import ops
    from repro_torch.search import optimize
    golden = json.loads(GOLDEN.read_text())
    launches = 0
    pat = traffic.pattern("uniform", **GOLDEN_PATTERN)
    for name in GOLDEN_TOPOS:
        topo = topology.build(name)
        for obj in OBJECTIVES:
            runs = []
            for rep in range(2):
                ops.PDHG_BURST_LAUNCHES = 0
                t0 = time.perf_counter()
                with trajectory() as traj:
                    res = search.optimize_placement(topo, pat, obj,
                                                    device=dev, **SEARCH_CFG)
                wall = time.perf_counter() - t0
                launches += ops.PDHG_BURST_LAUNCHES
                res.best.result.certificate.assert_ok(f"search {name}/{obj}")
                runs.append((search_summary(res), traj, wall))
            (a, ta, wall), (b, tb, _) = runs
            require(repr(a) == repr(b) and repr(ta) == repr(tb),
                    f"search {name}/{obj}: two card runs differ")
            want = golden[f"search/{name}/min-{obj}/sa/seed0"]
            pin = {"best": {"mappers": want["best_mappers"],
                            "reducers": want["best_reducers"],
                            "score": want["best_score"]},
                   "baselines": {k: {"mappers": a["baselines"][k]["mappers"],
                                     "reducers": a["baselines"][k]["reducers"],
                                     "score": v}
                                 for k, v in want["baselines"].items()},
                   **{k: want[k] for k in ("baseline_best", "evaluations",
                                           "dispatches", "gain")}}
            off = search_matches(a, pin)
            verdict = "the pin held"
            if off:
                # phase 14's rule: the CPU in the kernel's order gives the
                # card's run bitwise, and in torch's order the pin, but
                # for a pin the port's CPU run misses too, where the
                # test names the flipped comparison
                cpu = search_summary(search.optimize_placement(
                    topo, pat, obj, device="cpu", **SEARCH_CFG))
                if search_matches(a, cpu):
                    with in_kernel_order():
                        ko = search_summary(search.optimize_placement(
                            topo, pat, obj, device="cpu", **SEARCH_CFG))
                    require(repr(ko) == repr(a), f"search {name}/{obj}: the "
                            f"card differs from its kernel-order model")
                    verdict = ("the CPU in the kernel's order gives the "
                               "card's run bitwise; ")
                else:
                    verdict = "the card's run is the CPU's; "
                cpu_off = search_matches(cpu, pin)
                if not cpu_off:
                    verdict += ("in torch's order the CPU holds the pin: "
                                "flipped by the summation order")
                else:
                    require((name, obj) in SEARCH_PIN_FLIPS,
                            f"search {name}/{obj}: the CPU misses the pin "
                            f"too: {cpu_off}")
                    verdict += (f"the pin, which the port's CPU run misses "
                                f"too ({SEARCH_PIN_FLIPS[name, obj]}), "
                                f"missed in {off}")
            say(f"    SA {name}/{obj}: best {a['best']['mappers']}/"
                f"{a['best']['reducers']} score {a['best']['score']!r} gain "
                f"{a['gain']:.6f}, {a['evaluations']} evaluations in "
                f"{a['dispatches']} dispatches, {wall:.2f} s; two card runs "
                f"identical ({len(ta)} dispatches' candidates and scores); "
                f"{verdict}")
    # one generation's stages at the committed run's size (pon3 energy,
    # 8 candidates)
    topo = topology.build("pon3")
    ppat = traffic.pattern("uniform", n_map=6, n_reduce=4, total_gbits=20.0)
    cfg = search.SearchConfig(backend="pallas", device=dev)
    rng = np.random.default_rng(0)
    pls = [traffic.sample_placement(topo, ppat, rng) for _ in range(8)]
    map_out = traffic._map_outputs(ppat, np.random.default_rng(1))
    from repro_torch.core import timeslot
    n_slots = max(timeslot.suggest_n_slots(
        topo, traffic.generate_from_placement(topo, ppat, pl,
                                              map_out=map_out))
        for pl in pls)
    ops.PDHG_BURST_LAUNCHES = 0
    with stage_clock(batch_stages()) as spent:
        t0 = time.perf_counter()
        optimize.evaluate_placements(topo, ppat, pls, "energy",
                                     map_out=map_out, n_slots=n_slots,
                                     cfg=cfg)
        gen_wall = time.perf_counter() - t0
    launches += ops.PDHG_BURST_LAUNCHES
    say(f"    one generation (pon3, 6x4 of 20 Gbit, 8 candidates, one "
        f"stacked dispatch): {gen_wall:.3f} s: "
        + ", ".join(f"{k.strip()} {v:.3f}" for k, v in spent.items()))
    # the committed run
    evals, n_disp, in_eval = [0], [0], [0.0]
    real = optimize.evaluate_placements

    def counted(topo_, pat_, placements, *a, **kw):
        t1 = time.perf_counter()
        try:
            return real(topo_, pat_, placements, *a, **kw)
        finally:
            in_eval[0] += time.perf_counter() - t1
            evals[0] += len(placements)
            n_disp[0] += 1

    walls = []
    real_opt = search.optimize_placement

    def timed(*a, **kw):
        t1 = time.perf_counter()
        try:
            return real_opt(*a, **kw)
        finally:
            walls.append(time.perf_counter() - t1)

    with tempfile.TemporaryDirectory() as tmp:
        ops.PDHG_BURST_LAUNCHES = 0
        t0 = time.perf_counter()
        with mock.patch.object(optimize, "evaluate_placements", counted), \
                mock.patch.object(search, "optimize_placement", timed):
            rc, text = run_cli(PLACEMENT_ARGS + ["--out", tmp])
        wall = time.perf_counter() - t0
        launches += ops.PDHG_BURST_LAUNCHES
        rows = placement_rows(pathlib.Path(tmp) / "results.csv")
        md = (pathlib.Path(tmp) / "results.md").read_text()
    last = text.strip().splitlines()[-1]
    n_search = sum(k[4] != "none" for k in rows)
    say(f"    the committed placement run ({' '.join(PLACEMENT_ARGS)}): exit "
        f"{rc}, {len(rows)} rows ({n_search} of the search) in {wall:.1f} s;"
        f" {len(walls)} searches, {sum(walls):.1f} s: {evals[0]} "
        f"evaluations in {n_disp[0]} stacked dispatches "
        f"({evals[0] / sum(walls):.1f} evaluations a second of search, "
        f"{evals[0] / in_eval[0]:.1f} a second of dispatch)")
    require(rc == 0 and "(0 infeasible)" in last and "Placement search" in md,
            f"placement run: exit {rc}: {last}")
    ref = placement_rows(PLACEMENT_RESULTS)
    require(rows.keys() == ref.keys(), "placement run: other rows than the "
                                       "committed run's")
    off = {k: placement_row_diff(rows[k], ref[k]) for k in rows}
    off = {k: d for k, d in off.items() if d > SWEEP_RTOL}
    say(f"    against results/placement/results.csv (the reference's run): "
        f"{len(rows) - len(off)} of {len(rows)} rows within {SWEEP_RTOL:g} "
        f"on energy_j, completion_s and placement_gain; "
        f"{len(off)} off: {sorted(off)}")
    searches = sorted({(k[0], k[1], k[4], k[3]) for k in off})
    t0 = time.perf_counter()
    cpu = cpu_placement_rows(searches)
    ko, own = cpu["kernel"], cpu["torch"]
    say(f"    the {len(searches)} searches or LP cells holding them re-run "
        f"on the host CPU in both summation orders "
        f"({PLACEMENT_CPU_WORKERS} processes at a time): "
        f"{time.perf_counter() - t0:.1f} s")
    cpu_too = []
    for k in sorted(off):
        bad = [c for c in rows[k] if c != "solve_s"
               and rows[k][c] != ko[k][c]]
        require(not bad, f"placement row {k}: off the committed row by "
                         f"{off[k]:.3e}, and the kernel-order CPU run "
                         f"differs from the card in {bad}")
        d_own = placement_row_diff(own[k], ref[k])
        if d_own > SWEEP_RTOL:
            cpu_too.append(k)
    say(f"    every off row is the kernel-order CPU run's bitwise (every "
        f"column but solve_s), and in torch's order the committed row within "
        f"{SWEEP_RTOL:g}: flipped by the summation order")
    require(not cpu_too, f"placement rows the CPU run in torch's order "
                         f"misses too: {cpu_too}")
    return {"launches": launches, "evals_s": evals[0] / sum(walls),
            "dispatches": n_disp[0]}


def service_tenants(topo_name, k0=0):
    from repro_torch import service
    from repro_torch.core import arrivals, topology, traffic
    b = SERVICE_BENCH
    topo = topology.build(topo_name)
    pat = traffic.pattern("uniform", **b["pattern"])
    spec = arrivals.ArrivalSpec(n_coflows=b["coflows"],
                                mean_interarrival_s=b["mean_s"])
    return [service.TenantSpec(f"tenant{k}", topo, pat, spec, seed=k)
            for k in range(k0, k0 + b["tenants"])]


def tenant_metrics(res) -> list[tuple]:
    return [(t.energy_j, t.makespan_s, t.shipped_gbits, t.n_done)
            for t in res.tenants]


def service_phase(dev) -> int:
    """Phase 25: the golden two-tenant service run on the card against its
    pin (or the CPU under the order rule), two card runs with
    byte-identical event logs, service_bench's workload coalesced and
    serial in "measured" mode, two flagship tenants on fat-tree k=16,
    and the sweep's --service mode.  Returns the launch count."""
    import numpy as np
    from repro_torch import service
    from repro_torch.core import arrivals, topology, traffic
    from repro_torch.kernels import ops
    golden = json.loads(GOLDEN.read_text())["service/spine-leaf+pon3/seed0"]
    spec = arrivals.ArrivalSpec(n_coflows=2, mean_interarrival_s=2.0)
    pat = traffic.pattern("uniform", **GOLDEN_PATTERN)
    tenants = [service.TenantSpec("dcn", topology.build("spine-leaf"), pat,
                                  spec, seed=0, objective="energy"),
               service.TenantSpec("pon", topology.build("pon3"), pat, spec,
                                  seed=0, objective="time")]
    launches = 0

    def golden_run(d):
        return service.run_service(tenants, service.ServiceConfig(
            iters=3000, tol=2e-3,
            backend="pallas", device=d, verify_schedules=True))

    runs = []
    for rep in range(2):
        ops.PDHG_BURST_LAUNCHES = 0
        t0 = time.perf_counter()
        runs.append(golden_run(dev))
        wall = time.perf_counter() - t0
        launches += ops.PDHG_BURST_LAUNCHES
    a, b = runs
    require(a.event_log() == b.event_log(), "service: two card runs' event "
                                            "logs differ")
    got = {"total_energy_j": a.total_energy_j, "makespan_s": a.makespan_s,
           "tenant_energy_j": [t.energy_j for t in a.tenants],
           "tenant_shipped_gbits": [t.shipped_gbits for t in a.tenants],
           "tenant_makespan_s": [t.makespan_s for t in a.tenants]}
    exact = {"n_done": sum(r.status == "done" for r in a.requests),
             "arrived": a.counters.arrived, "admitted": a.counters.admitted}
    off = [k for k, v in got.items() if not np.allclose(
        v, golden[k], rtol=METRIC_RTOL, atol=1e-9)]
    off += [k for k, v in exact.items() if v != golden[k]]
    say(f"    golden two-tenant run (spine-leaf energy + pon3 time), card: "
        f"{len(a.events)} events, {a.counters.windows} windows, "
        f"{a.counters.dispatches} dispatches, {wall:.2f} s; E="
        f"{a.total_energy_j} J makespan {a.makespan_s:.6f} s; two card "
        f"runs byte-identical ('iterations' cost mode); "
        f"{'the pin held' if not off else 'off the pin in ' + str(off)}")
    if off:
        cpu = golden_run("cpu")
        if cpu.event_log() != a.event_log():
            with in_kernel_order():
                ko = golden_run("cpu")
            require(ko.event_log() == a.event_log(), "service: the card "
                    "differs from its kernel-order model")
        say("    the CPU run reproduces the card's event log (in the "
            "kernel's order where torch's differs)")
    # service_bench's workload, coalesced against serial, "measured" mode
    measured = service.SolveCostModel(mode="measured")
    for topo_name in ("spine-leaf", "pon3"):
        ten = service_tenants(topo_name)
        res, walls = {}, {}
        for coalesce in (False, True):
            cfg = service.ServiceConfig(
                iters=SERVICE_BENCH["iters"], tol=SERVICE_BENCH["tol"],
                backend="pallas", device=dev, coalesce=coalesce,
                overlap_build=coalesce,
                cost=measured)
            ops.PDHG_BURST_LAUNCHES = 0
            t0 = time.perf_counter()
            res[coalesce] = service.run_service(ten, cfg)
            walls[coalesce] = time.perf_counter() - t0
            launches += ops.PDHG_BURST_LAUNCHES
            require(res[coalesce].backlog_gbits <= 1e-6,
                    f"service bench {topo_name}: demand left")
        for x, y in zip(tenant_metrics(res[True]), tenant_metrics(res[False])):
            require(all(math.isclose(u, v, rel_tol=METRIC_RTOL, abs_tol=1e-9)
                        for u, v in zip(x, y)),
                    f"service bench {topo_name}: coalesced {x} vs serial {y}")
        busy = profile_device(lambda: service.run_service(ten, cfg))
        require(busy is not None, f"service bench {topo_name}: the "
                                  f"profiler saw no device time")
        busy_s = sum(us for _, us in busy.values()) * 1e-6
        for coalesce in (False, True):
            r, w = res[coalesce], walls[coalesce]
            done = sum(q.status == "done" for q in r.requests)
            say(f"    service_bench {topo_name}, {len(ten)} tenants, "
                f"{'coalesced' if coalesce else 'serial   '}: {done} co-flows"
                f" in {w:.3f} s = {done / w:.2f} co-flows/s; decision latency"
                f" p50 {r.latency.p50:.4f} s p99 {r.latency.p99:.4f} s; "
                f"{r.counters.dispatches} dispatches in "
                f"{r.counters.windows} windows "
                f"({r.counters.dispatches / r.counters.windows:.2f} a "
                f"window), {r.counters.solver_dispatches} stacked kernel "
                f"dispatches")
        say(f"    service_bench {topo_name}: coalesced/serial throughput "
            f"{walls[False] / walls[True]:.3f}x; every tenant's metrics "
            f"equal within {METRIC_RTOL:g}; device busy {busy_s:.4f} s in a "
            f"profiled coalesced run, of the unprofiled run's "
            f"{walls[True]:.3f} s (idle share "
            f"{1.0 - busy_s / walls[True]:.3f})")
    # two flagship tenants
    ft = topology.build(FULL[0], **FULL[1])
    fpat = traffic.pattern("uniform", **FULL[2])
    fspec = arrivals.ArrivalSpec(n_coflows=SERVICE_FT_COFLOWS,
                                 mean_interarrival_s=2.0)
    ften = [service.TenantSpec(f"ft{k}", ft, fpat, fspec, seed=k)
            for k in range(2)]
    ops.PDHG_BURST_LAUNCHES = 0
    with stage_clock((("driver", ops, "pdhg_adaptive"),)) as spent:
        t0 = time.perf_counter()
        fr = service.run_service(ften, service.ServiceConfig(
            backend="pallas", device=dev, path_slack=FULL[3]))
        wall = time.perf_counter() - t0
    n = ops.PDHG_BURST_LAUNCHES
    launches += n
    c = fr.counters
    say(f"    {ft.name}: 2 tenants, {SERVICE_FT_COFLOWS} poisson co-flows of "
        f"the flagship shuffle each (seeds 0, 1; shortest paths): "
        f"{c.windows} windows, "
        f"{c.dispatches} dispatches ({c.solver_dispatches} stacked, {n} "
        f"bursts), {c.retries} retries, {c.fallbacks} fallbacks; wall "
        f"{wall:.1f} s (adaptive driver {spent['driver']:.2f} s); latency "
        f"p50 {fr.latency.p50:.4f} s p99 {fr.latency.p99:.4f} s (virtual, "
        f"'iterations' model); makespan {fr.makespan_s:.4f} s, backlog "
        f"{fr.backlog_gbits:.3e} Gbit")
    require(fr.backlog_gbits <= 1e-6 and all(
        q.status == "done" for q in fr.requests), "flagship service: demand "
                                                  "left")
    with tempfile.TemporaryDirectory() as tmp:
        ops.PDHG_BURST_LAUNCHES = 0
        rc, text = run_cli(SERVICE_SWEEP_ARGS + ["--out", tmp])
        launches += ops.PDHG_BURST_LAUNCHES
        log = pathlib.Path(tmp) / "service_events.log"
        n_lines = len(log.read_text().splitlines()) if log.exists() else 0
    say(f"    {' '.join(SERVICE_SWEEP_ARGS)}: exit {rc}, "
        f"service_events.log {n_lines} lines; "
        + " | ".join(line.strip() for line in text.strip().splitlines()[1:3]))
    require(rc == 0 and n_lines > 0, f"--service 2: exit {rc}")
    return launches


# ---------------------------------------------------------------------------
# phases 26-27: the rest of the model zoo (MoE, xLSTM, encoder-decoder, VLM)
# ---------------------------------------------------------------------------

def recording_moe_inputs():
    """A patch under which every MoE layer's call records (layer, its
    input) in the returned list before it runs."""
    from repro_torch.models import moe
    seen, real = [], moe.MoE.forward

    def record(self, x):
        seen.append((self, x))
        return real(self, x)
    return mock.patch.object(moe.MoE, "forward", record), seen


def check_routing(label, seen) -> None:
    """Each MoE layer's routing on the card against the port on the CPU.
    From the router logits the card computed, the routing (top-k in its
    order, each pair's slot, which pairs fit, the expert counts) must be
    bitwise the CPU's.  From the layer input, the CPU's router product
    sums in another order than cuBLAS, so a logit may round to the next
    bf16 place, and a choice between two experts within a place may turn:
    how many logits and (token, k) choices differ is reported."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.common import matmul
    n_logits = n_turned = n_pairs = n_dropped = 0
    for i, (layer, x) in enumerate(seen):
        cfg = layer.cfg.moe
        xt = layer.groups(x)
        logits = layer.router_logits(xt)
        card = moe.route_logits(cfg, logits)
        cpu = moe.route_logits(cfg, logits.cpu())
        for name in ("topi", "slot", "keep", "counts"):
            require(torch.equal(getattr(card, name).cpu(),
                                getattr(cpu, name)),
                    f"{label} MoE layer {i}: {name} on the card is not the "
                    f"CPU's from the same logits")
        require(card.cap == cpu.cap and card.counts.dtype == torch.int64,
                f"{label} MoE layer {i}: capacity or count type")
        host = matmul(xt.cpu(), layer.weight("router", x.dtype).cpu())
        n_logits += int((host.float() != logits.cpu()).sum())
        n_turned += int((moe.route_logits(cfg, host.float()).topi
                         != card.topi.cpu()).sum())
        n_pairs += card.topi.numel()
        n_dropped += int((~card.keep).sum())
    say(f"    {label}, routing in {len(seen)} MoE layers ({n_pairs} (token, "
        f"k) pairs, {n_dropped} past capacity and dropped): top-k, slots, "
        f"kept pairs and expert counts bitwise the CPU's from the card's "
        f"logits; from the layer input the CPU's router product differs "
        f"in {n_logits} logits by bf16 places and turns {n_turned} "
        f"choices (reported, not bounded)")


def scale_err(got, want) -> float:
    """max |got - want| over want's largest magnitude, on the CPU."""
    want = want.float().cpu()
    return float((got.float().cpu() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def check_xlstm(model, batch) -> None:
    """The first mLSTM and sLSTM blocks on the card against the port on
    the CPU, on batch row 0 along the kernel path: each recurrence (the
    mLSTM's chunks, the sLSTM's steps) on the same fp32 inputs within
    XLSTM_RTOL of each output's scale, and the whole block within
    XLSTM_BLOCK_RTOL."""
    import torch
    from repro_torch.models import transformer, xlstm
    from repro_torch.models.common import rms_norm
    cpu = torch.device("cpu")
    kinds = [b.kind for b in model.blocks]
    x, _ = transformer._inputs(model, {"tokens": batch["tokens"][:1]})
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    done = 0
    with torch.no_grad():
        for kind in ("mlstm", "slstm"):
            i = kinds.index(kind)
            for block in model.blocks[done:i]:
                x = block(x, pos, mode="train")[0]
            cell = model.blocks[i].cell
            h = rms_norm(x, model.blocks[i].ln1, model.cfg.rms_eps)
            host = type(cell)(model.cfg, generator=torch.Generator(),
                              device=cpu)
            host.load_state_dict({k: v.cpu()
                                  for k, v in cell.state_dict().items()})
            t0 = time.perf_counter()
            if kind == "mlstm":
                q, k, v, logf, logi, _, _ = cell.project(h)
                got, got_state = cell.chunks(q, k, v, logf, logi)
                want, want_state = xlstm.MLSTM.chunks(
                    *(t.cpu() for t in (q, k, v, logf, logi)))
                # h = num / max(|q.n|, exp(-m)) a row: where q.n cancels,
                # a row's scale moves with the order of the sums; the
                # block uses h through the group norm, which removes it
                got, want = (xlstm.group_norm(t.transpose(1, 2), w)
                             for t, w in ((got, cell.gn), (want, host.gn)))
                names = ("group_norm(h)", "S", "n", "m")
            else:
                wx, _ = cell.project(h)
                B, D = h.shape[0], h.shape[2]
                z = torch.zeros((B, D), device=h.device)
                start = (z, z, z, torch.full((B, D), -1e30, device=h.device))
                got, got_state = cell.scan(wx, start)
                want, want_state = host.scan(
                    wx.cpu(), tuple(t.cpu() for t in start))
                names = ("h", "c", "n", "h_last", "m")
            errs = [scale_err(a, b) for a, b in
                    zip((got, *got_state), (want, *want_state))]
            out = cell(h, mode="train")[0]
            block_err = scale_err(out, host(h.cpu(), mode="train")[0])
            say(f"    xlstm layer {i} ({kind}), batch row 0, card vs CPU: "
                f"the recurrence on the same fp32 inputs, max |card-cpu| / "
                f"scale " + ", ".join(f"{n} {e:.3e}" for n, e in
                                      zip(names, errs))
                + f" (limit {XLSTM_RTOL:g}); the whole block {block_err:.3e}"
                f" (limit {XLSTM_BLOCK_RTOL:g}); {time.perf_counter() - t0:.1f}"
                f" s")
            require(max(errs) <= XLSTM_RTOL, f"xlstm layer {i} ({kind}): "
                    f"the card's recurrence is off the CPU's by "
                    f"{max(errs):.3e} of its scale")
            require(block_err <= XLSTM_BLOCK_RTOL, f"xlstm layer {i}: the "
                    f"block is off the CPU's by {block_err:.3e}")
            x = model.blocks[i](x, pos, mode="train")[0]
            done = i + 1
            del host


def zoo_phase(card: str) -> dict:
    """Phases 26-27 for each ZOO config in turn (the weights of one at a
    time on the card): serve it twice, check it, time it.  Returns the
    attention launches of one prefill of each config, summed."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.runtime import steps
    dev = torch.device("cuda", 0)
    B, P, G = ZOO_BATCH, ZOO_PROMPT, ZOO_GEN
    launches = 0
    for arch, layers in ZOO:
        t_phase = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg = configs.get(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        n_att = sum(k in ("attn", "attn_local")
                    for k in cfg.pattern_for(cfg.n_layers))
        pos0 = P + serve.prefix_len(cfg)
        say(f"[26] serving path: {cfg.name} at full width, {cfg.n_layers}"
            f"{f' of {layers * 2}' if layers else ''} layers"
            f"{f' + {cfg.n_enc_layers} encoder layers' if cfg.n_enc_layers else ''}"
            f", batch {B}, prompt {P}"
            f"{f' after {cfg.n_img_tokens} image tokens' if pos0 > P else ''}"
            f"{f' and {serve.ENC_FRAMES} encoder frames' if cfg.family == 'encdec' else ''}"
            f", {G} tokens, impl=kernel")
        served = []
        for rep in range(2):
            ops.FLASH_ATTENTION_LAUNCHES = 0
            ops.RGLRU_SCAN_LAUNCHES = 0
            ops.PDHG_BURST_LAUNCHES = 0
            t0 = time.perf_counter()
            if layers is None and rep == 0:
                served.append(serve.main([
                    "--arch", arch, "--batch", str(B), "--prompt-len",
                    str(P), "--gen", str(G), "--impl", "kernel"]))
            else:
                model = inputs = g = None     # one model on the card
                model, inputs = serve.build(cfg, B, P, 0, dev)
                g = serve.generate(model, inputs, G, impl="kernel")
                served.append(g.tokens.cpu().numpy())
            wall = time.perf_counter() - t0
            fa = ops.FLASH_ATTENTION_LAUNCHES
            say(f"    run {rep} ({'serve.main' if layers is None and rep == 0 else 'build + generate'}): "
                f"wall {wall:.3f} s (weights drawn on the card included); "
                f"flash_attention launches {fa}, rglru_scan "
                f"{ops.RGLRU_SCAN_LAUNCHES}, pdhg_burst "
                f"{ops.PDHG_BURST_LAUNCHES}")
            require(fa == n_att and ops.RGLRU_SCAN_LAUNCHES == 0,
                    f"{cfg.name} prefill launched the attention kernel {fa} "
                    f"times, expected {n_att}")
        launches += n_att
        require(served[0].shape == (B, G), f"tokens {served[0].shape}")
        require(np.array_equal(served[0], served[1]),
                f"two {cfg.name} serving runs differ")
        require(bool(torch.isfinite(g.prefill_logits).all()),
                f"{cfg.name} prefill logits not finite")
        require(np.array_equal(g.prefill_logits[:, -1].argmax(-1).cpu()
                               .numpy(), served[0][:, 0]),
                f"{cfg.name}: the first tokens are not the prefill's argmax")
        say(f"    two runs: identical tokens; {served[0][0][:8].tolist()} "
            f"...; prefill logits finite")
        if n_att:
            patch, seen = recording_moe_inputs()
            with patch:
                compare_sublayers(f"{cfg.name} prefill", model, inputs)
            if cfg.moe:
                check_routing(f"{cfg.name} prefill", seen)
            del seen
        else:
            check_xlstm(model, inputs)

        # -- phase 27 for this config --
        say(f"[27] times: {cfg.name} ({card})")
        prefill = steps.make_prefill_step(cfg, impl="kernel",
                                          max_len=pos0 + G)
        # run 1's prefill and two more (one more past a second: xlstm's)
        walls = [g.prefill_s]
        while len(walls) < (3 if g.prefill_s < 1.0 else 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(model, inputs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[(len(walls) - 1) // 2]
        say(f"    prefill wall {wall * 1e3:.3f} ms (the lower median of "
            + " / ".join(f"{w * 1e3:.3f}" for w in walls)
            + f", run 1's first); decode {g.decode_s / (G - 1) * 1e3:.3f} "
            f"ms a token ({G - 1} steps, batch {B})")
        report_busy("prefill", lambda: prefill(model, inputs), wall)
        decode = steps.make_decode_step(cfg, impl="kernel")
        memory = None
        if cfg.family == "encdec":
            with torch.no_grad():
                from repro_torch.models import transformer
                memory = transformer.encode(model, inputs["enc_embeds"])
        tok = g.tokens[:, -1:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(model, g.caches, tok, pos0 + G - 1, memory)
        torch.cuda.synchronize()
        report_busy("decode step", lambda: decode(model, g.caches, tok,
                                                  pos0 + G - 1, memory),
                    time.perf_counter() - t0)
        say(f"    peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB; phases 26-27 for {cfg.name} {time.perf_counter() - t_phase:.1f} s")
        del model, inputs, g, prefill, decode, tok, memory
        torch.cuda.empty_cache()

    say(f"[27] the attention kernel at the zoo's new shapes ({card})")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for seed, (name, Bq, S, H, Hkv, hd) in enumerate(ZOO_FA):
        q, k, v = fa_inputs(200 + seed, Bq, S, H, Hkv, hd, torch.bfloat16,
                            dev)
        err = compare_attention(f"{name} S={S} H={H}/{Hkv} hd={hd}", q, k,
                                v, 0, 0.0, True)
        ms = sorted(time_events(lambda: ops.flash_attention(q, k, v), 10)
                    for _ in range(3))[1]
        plain_ms = time_events(lambda: fa_plain(q, k, v, 0, 0.0), 3)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = time_events(lambda: sdpa(qt, kt, vt, is_causal=True,
                                          enable_gqa=True), 10)
        bound_ms, bound_by, nbytes, flop = attention_bound(
            Bq, S, H, Hkv, hd, 0, 2)
        del q, k, v, qt, kt, vt
        say(f"    {name}: attention kernel {ms:.6f} ms a launch (q ({Bq}, "
            f"{S}, {H}, {hd}), k/v ({Bq}, {S}, {Hkv}, {hd}), bf16, causal; "
            f"median of 3 runs of 10); plain {plain_ms:.6f} ms; library "
            f"{lib_ms:.6f} ms (torch scaled_dot_product_attention, "
            f"is_causal, enable_gqa); bound {bound_ms:.6f} ms ({bound_by}: "
            f"{flop} flop at 989 TFLOP/s bf16, {nbytes} B at 3.35 TB/s); "
            f"{flop / ms * 1e-9:.3f} TFLOP/s, {ms / bound_ms:.3f}x its bound,"
            f" {ms / lib_ms:.3f}x SDPA; max|kernel-plain| {err:.3e}")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phases 28-29: training
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording_train_steps():
    """While the block runs, every train step that
    `runtime.steps.make_train_step` builds records its wall (synchronised
    on both sides), its metrics and the model and optimizer state it
    returns, in the dict it yields."""
    import torch
    from repro_torch.runtime import steps
    real = steps.make_train_step
    rec = {"walls": [], "metrics": [], "model": None, "opt": None}

    def factory(*a, **kw):
        step = real(*a, **kw)

        def timed(model, opt_state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(model, opt_state, batch)
            torch.cuda.synchronize()
            rec["walls"].append(time.perf_counter() - t0)
            rec["metrics"].append({k: v.detach().clone()
                                   for k, v in out[2].items()})
            rec["model"], rec["opt"] = out[0], out[1]
            return out
        return timed

    with mock.patch.object(steps, "make_train_step", factory):
        yield rec


@contextlib.contextmanager
def timing_checkpoints():
    """While the block runs, each CheckpointManager.save and .restore
    appends (what, seconds, bytes of its arrays.npz) to the list it
    yields."""
    from repro_torch.ft import checkpoint
    done = []

    def wrap(name):
        real = getattr(checkpoint.CheckpointManager, name)

        def timed(self, *a, **kw):
            t0 = time.perf_counter()
            out = real(self, *a, **kw)
            step = a[0] if name == "save" else out[1]["step"]
            path = self.dir / f"step_{step:08d}" / "arrays.npz"
            done.append((name, time.perf_counter() - t0,
                         path.stat().st_size))
            return out
        return timed

    with mock.patch.object(checkpoint.CheckpointManager, "save",
                           wrap("save")), \
            mock.patch.object(checkpoint.CheckpointManager, "restore",
                              wrap("restore")):
        yield done


@contextlib.contextmanager
def skipping_save(step: int):
    """CheckpointManager.save writes nothing for `step` (phase 28's first
    phi4 run keeps one 17 GB write, its step-3 checkpoint)."""
    from repro_torch.ft import checkpoint
    real = checkpoint.CheckpointManager.save

    def save(self, at, *a, **kw):
        if at != step:
            return real(self, at, *a, **kw)
    with mock.patch.object(checkpoint.CheckpointManager, "save", save):
        yield


def report_checkpoints(done) -> None:
    for name, secs, nbytes in done:
        say(f"    checkpoint {name}: {secs:.2f} s for {nbytes / 1e9:.3f} GB "
            f"of arrays.npz ({nbytes / secs / 1e9:.3f} GB/s, the copy "
            f"between card and host included)")


def param_checksum(model) -> list[int]:
    """Each parameter's fp32 bit patterns summed as int64: a change of
    any bit of one weight changes it."""
    import torch
    return [int(p.detach().view(torch.int32).sum(dtype=torch.int64))
            for p in model.parameters()]


def train_batch_np(cfg, seed, B, S):
    """numpy inputs as tests/test_torch_train.py makes them: tokens,
    labels with two -1 columns, and the stub frontends' embeddings."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
           "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    out["labels"][:, :2] = -1
    out = {k: v.astype(np.int32) for k, v in out.items()}
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.standard_normal(
            (B, 12, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["img_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return out


def gate_biases(model) -> list[str]:
    """The xLSTM gate biases tests/test_torch_train.py holds to a share of
    their gate weight's gradient (their own gradients cancel to a tenth
    or less of their terms)."""
    out = []
    for i, block in enumerate(model.blocks):
        if block.kind in ("mlstm", "slstm"):
            out.append(f"blocks.{i}.cell.b_i")
        if block.kind == "mlstm":
            out.append(f"blocks.{i}.cell.b_f")
    return out


def grads_card_vs_cpu(arch, dev) -> str:
    """One gradient computation of a smoke config on the card and on the
    host CPU from the same weights and batch: loss, aux, the global norm
    and every gradient leaf, at the CPU tests' tolerances against the
    reference; each MoE layer's routing bitwise the CPU's from the card's
    router logits (phase 26's rule).  Returns a line to print."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.runtime import steps
    from repro_torch.train import optimizer as opt
    cfg = configs.get(arch, smoke=True)
    host = transformer.Transformer(
        cfg, generator=torch.Generator().manual_seed(0),
        device=torch.device("cpu"))
    card = transformer.Transformer(
        cfg, generator=torch.Generator(device=dev), device=dev)
    card.load_state_dict(host.state_dict())
    batch = {k: torch.from_numpy(v)
             for k, v in train_batch_np(cfg, 11, 2, 16).items()}
    patch, seen = recording_moe_inputs()
    with patch:
        loss, aux = steps.compute_grads(
            cfg, card, {k: v.to(dev) for k, v in batch.items()},
            remat=False)
    hloss, haux = steps.compute_grads(cfg, host, batch, remat=False)
    grads = {k: p.grad for k, p in card.named_parameters()}
    hgrads = {k: p.grad for k, p in host.named_parameters()}
    norm, hnorm = (float(opt.global_norm(g)) for g in (grads, hgrads))
    require(abs(float(loss) - float(hloss)) < TRAIN_LOSS_TOL,
            f"{arch} smoke: loss {float(loss)} on the card, {float(hloss)} "
            f"on the CPU")
    require(abs(float(aux) - float(haux)) <= 1e-3 * abs(float(haux)) + 1e-6,
            f"{arch} smoke: aux {float(aux)} vs {float(haux)}")
    require(abs(norm - hnorm) <= TRAIN_NORM_RTOL * hnorm,
            f"{arch} smoke: grad norm {norm} vs {hnorm}")
    biases = gate_biases(host)
    worst, worst_k = 0.0, ""
    for k, want in hgrads.items():
        got = grads[k].cpu()
        if k in biases:
            scale = float(hgrads[k.replace(".b_", ".w_")].abs().max())
        else:
            scale = float(want.abs().max())
        err = float((got - want).abs().max()) / max(scale, 1e-30)
        if err > worst:
            worst, worst_k = err, k
    require(worst <= TRAIN_GRAD_TOL, f"{arch} smoke: gradient {worst_k} "
            f"off the CPU's by {worst:.3e} of its scale")
    if cfg.moe:
        with torch.no_grad():
            check_routing(f"{cfg.name} train", seen)
    return (f"{cfg.name}: loss {float(loss):.6f} (CPU {float(hloss):.6f}), "
            f"grad norm {norm:.6f} (CPU {hnorm:.6f}), worst leaf {worst_k} "
            f"{worst:.3e} of its scale")


def train_flops(cfg, B, S) -> tuple[float, float]:
    """(model FLOPs of one train step, the remat recompute's FLOPs) for an
    attention-only config, counted: 6 x (the matmul weights a token
    meets: attention projections, the MLP or the top-k experts and the
    router, the unembedding) x tokens, plus attention's score and value
    products over all S keys (the einsum path computes the masked half
    too) x 3 for forward and backward; remat runs each layer's forward
    once more (2 x the layer weights x tokens, plus attention's forward).
    The MoE's dispatch and combine einsums and its capacity padding are
    not counted."""
    d, hd = cfg.d_model, cfg.hd
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    layer = 2 * d * H * hd + 2 * d * Hkv * hd
    if cfg.moe:
        m = cfg.moe
        layer += d * m.n_experts + m.top_k * 3 * d * m.d_expert
    else:
        gated = cfg.mlp_kind in ("swiglu", "geglu")
        layer += (3 if gated else 2) * d * cfg.d_ff
    T = B * S
    L = cfg.n_layers
    attn = 4 * S * H * hd * L
    model = T * (6 * (L * layer + d * cfg.padded_vocab(1)) + 3 * attn)
    remat = T * (2 * L * layer + attn)
    return float(model), float(remat)


def time_step_parts(cfg, model, opt_state, batch, ocfg):
    """One train step split on the card: the forward with its graph (CE
    included), the backward (remat's recompute included) and the AdamW
    update, each timed by CUDA events, in ms."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.common import cross_entropy
    from repro_torch.runtime import steps
    from repro_torch.train import optimizer as opt
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    torch.cuda.synchronize()
    ev[0].record()
    with torch.enable_grad():
        logits, aux = transformer.train_logits(model, batch, remat=True)
        loss = cross_entropy(logits, batch["labels"],
                             n_real_vocab=cfg.vocab_size)
        del logits
        total = loss + steps.AUX_WEIGHT * aux
        ev[1].record()
        total.backward()
    ev[2].record()
    grads = {k: p.grad for k, p in params.items()}
    opt.adamw_update(ocfg, params, grads, opt_state)
    ev[3].record()
    torch.cuda.synchronize()
    for p in params.values():
        p.grad = None
    return tuple(ev[i].elapsed_time(ev[i + 1]) for i in range(3))


def dispatch_ms(layer, x) -> float:
    """One MoE layer's dispatch at the layer's training shape, forward and
    backward, in ms (CUDA events, median of 3): the routing, the dispatch
    and combine tensors and their two einsums, with the gradient of the
    combine into the gates and of both einsums into the tokens and the
    experts' outputs.  The experts' own products are not in it."""
    import torch
    from repro_torch.models.common import einsum
    xt = layer.groups(x).detach().requires_grad_(True)
    with torch.no_grad():
        r0 = layer.route(xt)
    eout = torch.randn((xt.shape[0], r0.probs.shape[-1], r0.cap,
                        xt.shape[-1]), device=x.device,
                       dtype=x.dtype).requires_grad_(True)

    def run():
        with torch.enable_grad():
            r = layer.route(xt)
            disp, comb = layer.dispatch(r, xt.dtype)
            xin = einsum("ngec,ngd->necd", disp, xt)
            out = einsum("ngec,necd->ngd", comb, eout)
            torch.autograd.backward([xin, out],
                                    [torch.ones_like(xin),
                                     torch.ones_like(out)])
    return sorted(time_events(run, 3) for _ in range(3))[1]


def train_phase(card: str, dev=None) -> dict:
    """Phases 28-29: the launcher on phi4-mini (8 layers) and granite-moe
    at full width, twice each, phi4 resumed from its step-3 checkpoint;
    remat and micro-batching on the card; a run that must learn; the ten
    smoke configs card against CPU; then the times of a step."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.runtime import steps
    from repro_torch.train import optimizer as opt
    dev = torch.device("cuda", 0) if dev is None else dev
    out = {}
    ckpt = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-ckpt-"))
    try:
        for arch, args, n_steps in TRAIN_RUNS:
            cfg = train.scale_config(configs.get(arch),
                                     n_layers=int(args[args.index(
                                         "--n-layers") + 1])
                                     if "--n-layers" in args else None)
            B = int(args[args.index("--batch") + 1])
            S = int(args[args.index("--seq") + 1])
            argv = ["--arch", arch, "--device", str(dev), "--steps",
                    str(n_steps), "--log-every", "1", "--seed", "0", *args]
            with_ckpt = arch == TRAIN_RESUME
            say(f"[28] training: {cfg.name} at full width, {cfg.n_layers} "
                f"layers, batch {B} x seq {S}, {n_steps} steps through "
                f"launch.train.main, twice"
                + (f"; checkpoints every {TRAIN_CKPT_EVERY} steps in the "
                   f"first run, then resumed" if with_ckpt else ""))
            runs = []
            for rep in range(2):
                extra = (["--ckpt-dir", str(ckpt), "--ckpt-every",
                          str(TRAIN_CKPT_EVERY)]
                         if with_ckpt and rep == 0 else [])
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                with recording_train_steps() as rec, \
                        timing_checkpoints() as io, \
                        (skipping_save(n_steps) if extra
                         else contextlib.nullcontext()):
                    losses = train.main(argv + extra)
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated() / 2**30
                norms = [m["grad_norm"] for m in rec["metrics"]]
                auxes = [float(m["aux_loss"]) for m in rec["metrics"]]
                runs.append(dict(losses=losses, norms=norms, auxes=auxes,
                                 walls=rec["walls"], peak=peak,
                                 sum=param_checksum(rec["model"])))
                say(f"    run {rep}: {wall:.1f} s (weights drawn, co-flow "
                    f"plan{', 2 checkpoints' if extra else ''} included); "
                    f"losses " + " ".join(f"{x:.6f}" for x in losses)
                    + "; grad norms " + " ".join(
                        f"{float(n):.6f}" for n in norms)
                    + (f"; aux " + " ".join(f"{a:.6f}" for a in auxes)
                       if cfg.moe else "")
                    + f"; step walls " + " ".join(
                        f"{w * 1e3:.1f}" for w in rec["walls"])
                    + f" ms; peak device memory {peak:.2f} GiB")
                require(all(math.isfinite(x) for x in losses)
                        and all(bool(torch.isfinite(n)) for n in norms),
                        f"{cfg.name}: a loss or grad norm is not finite")
                if cfg.moe:
                    require(all(math.isfinite(a) and a > 0 for a in auxes),
                            f"{cfg.name}: aux loss {auxes}")
                report_checkpoints(io)
                if rep == 1:
                    model, opt_state = rec["model"], rec["opt"]
                rec.clear()
            a, b = runs
            require(a["losses"] == b["losses"]
                    and all(torch.equal(x, y)
                            for x, y in zip(a["norms"], b["norms"]))
                    and a["sum"] == b["sum"],
                    f"{cfg.name}: two runs from --seed 0 differ")
            say(f"    two runs bitwise equal: losses, grad norms and the "
                f"final parameters' checksum (the sum of their fp32 bit "
                f"patterns a tensor, {len(a['sum'])} tensors)")
            # -- phase 29 for this config --
            say(f"[29] times: {cfg.name} train step, batch {B} x seq {S} "
                f"({card})")
            walls = b["walls"][1:]
            step_s = float(np.median(walls))
            tokens = B * S
            model_flop, remat_flop = train_flops(cfg, B, S)
            ocfg = opt.AdamWConfig(lr=3e-4, total_steps=n_steps,
                                   warmup_steps=5)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     pipeline._batch_at(pipeline.DataConfig(
                         vocab_size=cfg.vocab_size, batch=B, seq=S,
                         seed=0), n_steps).items()}
            with train.reproducible(dev):
                fwd, bwd, upd = time_step_parts(cfg, model, opt_state, batch,
                                                ocfg)
                step = steps.make_train_step(cfg, ocfg, remat=True)
                report_busy("train step", lambda: step(model, opt_state,
                                                       batch), step_s)
                disp = None
                if cfg.moe:
                    patch, seen = recording_moe_inputs()
                    with patch, torch.no_grad():
                        transformer.train_logits(model, batch)
                    disp = dispatch_ms(seen[0][0], seen[0][1])
                    del seen
            parts = fwd + bwd + upd
            say(f"    train step {step_s * 1e3:.3f} ms (median of steps "
                f"1-{len(b['walls']) - 1} of run 1, "
                + " / ".join(f"{w * 1e3:.3f}" for w in walls)
                + f"); {tokens / step_s:.1f} tokens a second; "
                f"peak device memory {b['peak']:.2f} GiB")
            say(f"    model {model_flop / step_s * 1e-12:.3f} TFLOP/s "
                f"({model_flop:.4e} flop a step: 6 x matmul weights x tokens"
                f" + attention's S x S products x 3); with the remat "
                f"recompute {(model_flop + remat_flop) / step_s * 1e-12:.3f}"
                f" TFLOP/s (+{remat_flop:.4e} flop); of 989 TFLOP/s bf16")
            say(f"    one step in parts (CUDA events): forward with its "
                f"graph and the CE {fwd:.3f} ms, backward (remat recompute "
                f"included) {bwd:.3f} ms, AdamW update {upd:.3f} ms: the "
                f"optimizer's share {upd / parts:.3f} of {parts:.3f} ms")
            if disp is not None:
                L = cfg.n_layers
                say(f"    MoE dispatch (routing, dispatch and combine "
                    f"tensors, their two einsums, forward and backward) "
                    f"{disp:.3f} ms a layer at the layer's shape, x {L} "
                    f"layers = {disp * L:.3f} ms: {disp * L / bwd:.3f} of "
                    f"the backward")
            out[arch] = dict(step_ms=step_s * 1e3, tokens_s=tokens / step_s,
                             peak_gib=b["peak"], opt_share=upd / parts)
            del model, opt_state, batch, step, runs, b
            torch.cuda.empty_cache()
            if with_ckpt:
                # the step-6 save was skipped (skipping_save): point
                # LATEST at it, as a crash after the pointer's rename
                # but before the directory's write would leave it
                saved = sorted(d.name for d in ckpt.glob("step_*"))
                require(saved == [f"step_{TRAIN_CKPT_EVERY:08d}"],
                        f"checkpoints written: {saved}")
                (ckpt / "LATEST").write_text(f"step_{n_steps:08d}")
                latest = (ckpt / "LATEST").read_text()
                # its end-of-run save (step 6 again) is skipped too:
                # nothing reads it
                with recording_train_steps() as rec, \
                        timing_checkpoints() as io, skipping_save(n_steps):
                    resumed = train.main(argv + ["--ckpt-dir", str(ckpt),
                                                 "--resume"])
                first = int(rec["metrics"][0]["step"])
                rec.clear()
                require(latest == f"step_{n_steps:08d}" and
                        first == TRAIN_CKPT_EVERY + 1,
                        f"resume did not start from step "
                        f"{TRAIN_CKPT_EVERY}: LATEST {latest}, first step "
                        f"{first}")
                require(resumed == a["losses"][TRAIN_CKPT_EVERY:],
                        f"the resumed run's losses {resumed} are not the "
                        f"first run's {a['losses'][TRAIN_CKPT_EVERY:]}")
                report_checkpoints(io)
                say(f"[28] resume: step_{n_steps:08d} not written (LATEST "
                    f"named it): --resume restarted from step "
                    f"{TRAIN_CKPT_EVERY} "
                    f"and repeated losses {TRAIN_CKPT_EVERY}-{n_steps - 1} "
                    f"bitwise")

            del a
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    with train.reproducible(dev):
        # remat changes memory, not numbers (granite cut to 4 layers)
        cfg = dataclasses.replace(configs.get("granite-moe-1b-a400m"),
                                  n_layers=4)
        model = transformer.Transformer(
            cfg, generator=torch.Generator(device=dev).manual_seed(1),
            device=dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 train_batch_np(cfg, 3, *TRAIN_CHECK_BS).items()}
        start = {k: v.detach().clone() for k, v in model.state_dict().items()}
        got = []
        for remat in (True, False):
            model.load_state_dict(start)
            loss, aux = steps.compute_grads(cfg, model, batch, remat=remat)
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
            state = opt.adamw_init(dict(model.named_parameters()))
            step = steps.make_train_step(cfg, opt.AdamWConfig(),
                                         remat=remat)
            _, _, m = step(model, state, batch)
            got.append((loss, aux, grads, m["loss"],
                        {k: p.detach().clone()
                         for k, p in model.named_parameters()}))
        (l1, a1, g1, s1, p1), (l2, a2, g2, s2, p2) = got
        require(torch.equal(l1, l2) and torch.equal(a1, a2)
                and torch.equal(s1, s2)
                and all(torch.equal(g1[k], g2[k]) for k in g1)
                and all(torch.equal(p1[k], p2[k]) for k in p1),
                "remat on and off differ")
        say(f"[28] remat on and off, {cfg.name} at 4 layers, batch "
            f"{TRAIN_CHECK_BS[0]} x {TRAIN_CHECK_BS[1]}:"
            f" loss {float(l1):.6f}, aux {float(a1):.6f}, all {len(g1)} "
            f"gradients and one step's parameters bitwise equal")
        del got, g1, g2, p1, p2, grads, start

        # it learns: 8 steps on one repeated batch
        cfg = configs.get("granite-moe-1b-a400m")
        model = transformer.Transformer(
            cfg, generator=torch.Generator(device=dev).manual_seed(2),
            device=dev)
        state = opt.adamw_init(dict(model.named_parameters()))
        step = steps.make_train_step(cfg, opt.AdamWConfig(
            lr=1e-3, warmup_steps=1, total_steps=8))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 pipeline._batch_at(pipeline.DataConfig(
                     vocab_size=cfg.vocab_size, batch=TRAIN_CHECK_BS[0],
                     seq=TRAIN_CHECK_BS[1], seed=1),
                     0).items()}
        losses = []
        for _ in range(8):
            model, state, m = step(model, state, batch)
            losses.append(float(m["loss"]))
        require(losses[-1] < losses[0], f"granite did not learn: {losses}")
        say(f"[28] {cfg.name}, 8 steps on one batch (lr 1e-3, warm-up 1):"
            f" losses " + " ".join(f"{x:.4f}" for x in losses))
        del model, state, step, batch
        torch.cuda.empty_cache()

        # micro-batching against the whole batch (tests/test_microbatch.py)
        cfg = configs.get("phi4-mini-3.8b", smoke=True)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in train_batch_np(cfg, 5, 4, 64).items()}
        res = []
        for n in (1, 2):
            model = transformer.Transformer(
                cfg, generator=torch.Generator(device=dev).manual_seed(0),
                device=dev)
            state = opt.adamw_init(dict(model.named_parameters()))
            res.append(steps.make_train_step(
                cfg, opt.AdamWConfig(total_steps=10), microbatches=n)(
                    model, state, batch))
        (m1, _, r1), (m2, _, r2) = res
        dl = abs(float(r1["loss"]) - float(r2["loss"]))
        with torch.no_grad():
            dp = max(float(((a - b).abs() - MB_ATOL - MB_RTOL * b.abs())
                           .max())
                     for a, b in zip(m1.parameters(), m2.parameters()))
        require(dl < MB_LOSS_TOL and dp <= 0, f"microbatches=2 against 1: "
                f"loss {dl:.3e}, parameters {dp:.3e} past the tolerance")
        say(f"[28] microbatches=2 against 1 ({cfg.name}, batch 4 x 64): "
            f"loss within {dl:.3e} (limit {MB_LOSS_TOL:g}), parameters "
            f"within atol {MB_ATOL:g} + rtol {MB_RTOL:g}")
        del res, m1, m2

        say("[28] the ten smoke configs, one gradient on the card and on "
            "the host CPU from the same weights and batch")
        for arch in TRAIN_SMOKE:
            say("    " + grads_card_vs_cpu(arch, dev))
    return out


# ---------------------------------------------------------------------------
# phases 30-31: the row-sharded solve and the scheduled gradient all-reduce
# ---------------------------------------------------------------------------

def sharded_args(lp, shards, dev):
    """The solver's sharded packing of `lp` (_pack_pallas_sharded, the
    global layout) started from lp_burst_args's seeded point inside the
    box: (op, the 14 operands of pdhg_burst_sharded for every shard)."""
    import numpy as np
    from repro_torch.core import solver
    xmax = np.where(np.isfinite(lp.xmax), lp.xmax, 1e12)
    cscale = max(float(np.abs(lp.c).max(initial=0.0)), 1e-12)
    op, vecs, ell = solver._pack_pallas_sharded(
        lp.c / cscale, lp.row, lp.col, lp.val, lp.b, lp.h, xmax, lp.m_eq,
        shards, dev)
    return op, vecs + random_start(lp, xmax, op.n_pad, op.m_pad, dev, ell)


def shard_operands(op, args, first, count):
    """The operands of shards [first, first + count) of sharded_args's:
    the x side whole, the y side and the tables of those shards."""
    from repro_torch.kernels import pdhg_spmv
    c, tau, xmax, q, sig, ub, keep_n, keep_m, ri, rv, ci, cv, x0, y0 = args
    ys = slice(first * op.m_loc, (first + count) * op.m_loc)
    rs, cs = (pdhg_spmv.table_len(op.row_meta),
              pdhg_spmv.table_len(op.col_meta))
    return (c, tau, xmax, q[ys], sig[ys], ub[ys], keep_n, keep_m[ys],
            ri[first * rs:(first + count) * rs],
            rv[first * rs:(first + count) * rs],
            ci[first * cs:(first + count) * cs],
            cv[first * cs:(first + count) * cs], x0, y0[ys])


def split_kw(op, dev, iters, precision, shards=None):
    from repro_torch.kernels import pdhg_spmv
    return dict(row_meta=op.row_meta, col_meta=op.col_meta, iters=iters,
                precision=precision,
                **pdhg_spmv.sharded_work(op, dev, shards))


def check_split(label, op, args, iters, precision,
                sms) -> tuple[float, bool]:
    """Phase 30(a): the split step (one process holding all S shards: a
    whole burst one cooperative launch) on as many blocks as fit and on
    one block an SM (`sms`), each against the plain body summing in the
    kernel's order, bitwise over (x, y, worst); at one shard also
    against the fused kernel, bitwise.  Returns the largest |split -
    plain| (the plain body in torch's order) and whether that plain body
    differs bitwise (so the check can fail)."""
    import torch
    from repro_torch.kernels import ops, pdhg_spmv
    dev = args[0].device
    kw = split_kw(op, dev, iters, precision)
    model = pdhg_spmv.pdhg_update_burst_sharded(
        args[12], args[13], *args[:12], **kw, order="kernel")
    plain = pdhg_spmv.pdhg_update_burst_sharded(
        args[12], args[13], *args[:12],
        **{k: v for k, v in kw.items() if not k.endswith("_work")})
    one = None
    if op.shards == 1:
        one = ops.pdhg_burst(*args, row_meta=op.row_meta,
                             col_meta=op.col_meta, iters=iters,
                             precision=precision,
                             row_work=kw["row_work"][0],
                             col_work=kw["col_work"][0])
    err, differs = 0.0, False
    for blocks, grid in ((0, "as many blocks as fit"),
                         (sms, "one block an SM")):
        before = ops.PDHG_SPLIT_LAUNCHES
        got = ops.pdhg_burst_sharded(None, *args, **kw, _blocks=blocks)
        torch.cuda.synchronize()
        launches = ops.PDHG_SPLIT_LAUNCHES - before
        same = all(torch.equal(a, b) for a, b in zip(got, model))
        fused = ""
        if one is not None:
            same_fused = all(torch.equal(a, b) for a, b in zip(got, one))
            fused = f"; to the fused kernel: {same_fused}"
            require(same_fused, f"{label}: the split step at one shard "
                                f"({grid}) differs from the fused kernel")
        err = max([err] + [float((a - b).abs().max())
                           for a, b in zip(got, plain)])
        differs |= not all(torch.equal(a, b) for a, b in zip(got, plain))
        say(f"  {label} S={op.shards} {precision} iters={iters} ({grid}, "
            f"{launches} launch): bitwise equal to the kernel-order model: "
            f"{same}{fused}; max|split - plain| {err:.3e}")
        off = max(float((a - b).abs().max()) for a, b in zip(got, model))
        require(same, f"{label} S={op.shards} {precision} iters={iters} "
                      f"({grid}): the split step differs from the "
                      f"kernel-order model by {off:.3e}")
        require(launches == 1, f"{label}: a burst without a collective "
                               f"took {launches} launches, not one")
        require(all(bool(torch.isfinite(t).all()) for t in got),
                f"{label}: split output not finite")
        require(bool((got[0][op.n:] == 0).all()),
                f"{label}: a padded x moved")
    return err, differs


def split_plan(group, op, args, precision):
    """A burst plan (ops.ShardedBurst) over sharded_args's operands of
    one process holding every shard."""
    from repro_torch.kernels import ops
    kw = split_kw(op, args[0].device, 0, precision)
    del kw["iters"]
    return ops.ShardedBurst(group, *args[:12], **kw)


def split_device_ms(group, op, args, precision) -> dict:
    """The split step's own device time, two ways.  torch's profiler
    (CUPTI): the step kernel's durations over one burst of
    SPLIT_OWN_ITERS (without a group one launch of the whole burst, its
    begin and finish phases in it; over NCCL one launch an iteration),
    ms an iteration.  CUDA events: one step launch (a step from buffer 0)
    relaunched SPLIT_OWN_REPS times back to back between two events,
    behind a sleeping kernel that keeps the stream ahead of the host, so
    the events time what the stream spends a launch, the kernel and the
    device's turnaround between two launches, and not the host's gaps (a
    relaunch with the same operands computes the same step again).
    Returns {"cupti": ... (None unless the profiler saw every launch),
    "events": ..., "seen", "launched": the step's records and launches
    in the profiled burst}, ms."""
    import torch
    from repro_torch.kernels import ops
    plan = split_plan(group, op, args, precision)
    x0, y0 = args[12], args[13]
    plan(x0, y0, SPLIT_OWN_ITERS)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPLIT_SLEEP_CYCLES)
    e0.record()
    for _ in range(SPLIT_OWN_REPS):
        plan._launch(1, 0, 0, 0)
    e1.record()
    torch.cuda.synchronize()
    events = e0.elapsed_time(e1) / SPLIT_OWN_REPS
    # late in a whole run of this script the profiler keeps only some of
    # the step's records: a time is kept only when it saw every launch
    before = ops.PDHG_SPLIT_LAUNCHES
    prof = profile_device(lambda: plan(x0, y0, SPLIT_OWN_ITERS)) or {}
    launched = ops.PDHG_SPLIT_LAUNCHES - before
    seen = [v for name, v in prof.items() if "pdhg_split_step" in name]
    count = sum(c for c, _ in seen)
    cupti = (sum(us for _, us in seen) / 1e3 / SPLIT_OWN_ITERS
             if count == launched else None)
    return {"events": events, "cupti": cupti, "seen": count,
            "launched": launched}


def split_step_ptxas(log: str) -> list[str]:
    """The split step's lines of nvcc's -Xptxas -v log, in phase 7's
    form: its storage type, registers and spill bytes."""
    out = [t for t in ptxas_templates(log) if "pdhg_split_step" in t]
    return [re.sub(r"\S*pdhg_split_stepI(\w+?)EEv\w*",
                   lambda m: "pdhg_split_step<"
                   + ("bf16" if "bfloat16" in m.group(1) else "fp32") + ">",
                   t) for t in out]


def split_bound(op_s, op, nnz, it=4) -> tuple[float, str]:
    """Least time of one iteration of the split form: the fused burst's
    bytes and operations (burst_bound) plus the S partials of K^T y
    written once and read once."""
    ms, by, nbytes, nops = burst_bound(op, nnz, it)
    nbytes += 2 * 4 * op_s.shards * op_s.n_pad
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = nops / FP32_OPS_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def reset_split_counts():
    from repro_torch.kernels import ops
    ops.PDHG_SPLIT_LAUNCHES = 0
    ops.PDHG_SPLIT_BF16_LAUNCHES = 0
    ops.PDHG_SPLIT_GRAPH_REPLAYS = 0
    ops.PDHG_SHARDED_CALLS = 0
    ops.PDHG_BURST_LAUNCHES = 0


def grad_plan(leaves, bucket_bytes, dev):
    """Buckets of `leaves` (runtime.collectives.bucketize) and a plan for
    them from core.fabric.plan_collectives over the v5e fabric, each
    bucket released a quarter slot after the one before and free to use
    either axis, as fabric.grad_buckets_for stagers a model's layers."""
    from repro_torch.core import fabric
    from repro_torch.runtime import collectives
    ids = collectives.bucketize(leaves, bucket_bytes)
    buckets = [fabric.Bucket(f"b{i}", float(sum(
        leaves[j].numel() * leaves[j].element_size() for j in ids[i])),
        (0, 1), int(i * 0.25)) for i in range(len(ids))]
    n_slots = max(8, int((len(ids) - 1) * 0.25) + 2)
    plan = fabric.plan_collectives(fabric.v5e_fabric(), buckets,
                                   n_slots=n_slots, device=dev)
    return ids, plan


def check_issue_order(issued, plan) -> bool:
    """The collectives went out slot group by slot group, each bucket of
    slot t before any of slot t + 1 (runtime.collectives' `issued`)."""
    order = plan.slot_order()
    slots = [s for s, _, _ in issued]
    first = list(dict.fromkeys(b for _, b, _ in issued))
    return slots == sorted(slots) and first == [b for g in order for b in g]


def small_grads(rank, dev):
    """A small gradient tree, distinct per rank (numpy seeded by rank)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(100 + rank)

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)
    return {"a": t(64, 128), "b": [t(4096), t(32, 32)], "c": t(1000, 3),
            "d": t(77)}


def shard_rank_main(rank, world, out_dir) -> int:
    """The --shard-rank mode (phase 30(c) and 31's two ranks): one rank of
    a `world`-rank gloo world on cuda:0, joined through a FileStore in
    out_dir.  Runs the fixed-iteration burst twice, waits for the file
    `go` in out_dir, then runs SHARD_RANK_TOPOS (the first twice) and
    the flagship through solve_fast(shards=world), times an
    iteration and the collective (with and without the pinned staging),
    and the scheduled gradient sync on a small tree, then phase 32(c)
    (sharded_rank_part); writes rank<r>.json and rank<r>_x.npy to
    out_dir."""
    import datetime
    import hashlib
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.core import solver, verify
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lmesh
    from repro_torch.runtime import collectives
    out_dir = pathlib.Path(out_dir)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    # phase 32(c)'s bf16 products summed in fp32, as in the parent
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(out_dir / "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    group = dist.group.WORLD
    res: dict = {}
    try:
        p_full = problem(*FULL)
        lp_full, _ = solver.build_routing_lp(p_full, "energy")
        # (c) the split step over `world` ranks, a fixed burst
        op, args = sharded_args(lp_full, world, dev)
        xs = [ops.pdhg_burst_sharded(
            group, *shard_operands(op, args, rank, 1),
            **split_kw(op, dev, SHARD_FIXED_ITERS, "fp32", [rank]))[0]
            .cpu().numpy() for _ in range(2)]
        res["fixed_repeat"] = bool(np.array_equal(xs[0], xs[1]))
        np.save(out_dir / f"rank{rank}_x.npy", xs[0])
        # wait for the parent's go: it runs its own parts of phase 30 on
        # the card until then, and the solves below share the card with
        # no other process's kernels
        deadline = time.monotonic() + SHARD_TIMEOUT_S
        while not (out_dir / "go").exists():
            require(time.monotonic() < deadline, "no go from phase 30")
            time.sleep(0.05)
        # the main path: solve_fast(shards=world) on the card
        reset_split_counts()
        runs = {}
        # the paper topologies (spine-leaf twice), then the flagship
        cells = [(name, problem(name, {}, GOLDEN_PATTERN, 2))
                 for name in SHARD_RANK_TOPOS] + [("flagship", p_full)]
        cells.insert(1, ("spine-leaf#1", cells[0][1]))
        for key, p in cells:
            t0 = time.perf_counter()
            r = solver.solve_fast(p, "energy", shards=world,
                                  backend="pallas", device=dev)
            runs[key] = (p, r, time.perf_counter() - t0)
        res["launches"] = ops.PDHG_SPLIT_LAUNCHES
        res["fused_launches"] = ops.PDHG_BURST_LAUNCHES
        res["runs"] = {
            k: dict(metrics_of(r), iterations=int(r.iterations), wall=wall,
                    cert_ok=bool(verify.check_schedule(p, r.schedule).ok),
                    x=hashlib.sha256(r.lp_x.tobytes()).hexdigest(),
                    schedule=hashlib.sha256(
                        np.ascontiguousarray(r.schedule).tobytes())
                    .hexdigest())
            for k, (p, r, wall) in runs.items()}
        # (d) an iteration at `world` ranks, and the collective alone
        local = shard_operands(op, args, rank, 1)
        kw = split_kw(op, dev, SHARD_RANK_TIME_ITERS, "fp32", [rank])
        for _ in range(2):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ops.pdhg_burst_sharded(group, *local, **kw)
            torch.cuda.synchronize()
            res["iter_ms"] = (time.perf_counter() - t0) * 1e3 \
                / SHARD_RANK_TIME_ITERS
        parts = torch.zeros((1, op.n_pad), device=dev)
        gather = ops.ShardGather(group, (1, op.n_pad), torch.float32, dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(SHARD_RANK_TIME_ITERS):
            gather(parts)
        torch.cuda.synchronize()
        res["collective_ms"] = (time.perf_counter() - t0) * 1e3 \
            / SHARD_RANK_TIME_ITERS
        # the same gather handed to gloo as CUDA tensors (no staging of
        # our own): what ShardGather's pinned buffers are measured against
        rows = list(torch.zeros((world, op.n_pad), device=dev).unbind(0))
        flat = parts.reshape(-1)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(SHARD_RANK_TIME_ITERS):
            dist.all_gather(rows, flat, group=group)
        torch.cuda.synchronize()
        res["direct_ms"] = (time.perf_counter() - t0) * 1e3 \
            / SHARD_RANK_TIME_ITERS
        # phase 31: the scheduled sync over a (world, 1) mesh
        mesh = lmesh.make_host_mesh((world, 1), ("data", "model"))
        grads = small_grads(rank, dev)
        leaves = [leaf for _, leaf in tree.flatten(grads)]
        ids, plan = grad_plan(leaves, 16 * 1024, dev)
        issued: list = []
        synced = collectives.make_scheduled_grad_sync(
            mesh, plan, ids, ("data",), issued=issued)(grads)
        mean = [torch.stack([tree.flatten(small_grads(r, dev))[i][1]
                             for r in range(world)]).double().mean(0)
                for i in range(len(leaves))]
        res["sync_err"] = max(float((s.double() - m).abs().max())
                              for (_, s), m in zip(tree.flatten(synced),
                                                   mean))
        res["sync_scale"] = max(float(m.abs().max()) for m in mean)
        res["sync_buckets"] = len(ids)
        res["sync_slots"] = len(plan.slot_order())
        res["sync_order_ok"] = check_issue_order(issued, plan)
        res["sync_collectives"] = len(issued)
        # phase 32(c): the sharded steps at `world` ranks
        t0 = time.perf_counter()
        res["sharded"] = sharded_rank_part(rank, world, dev, out_dir)
        res["sharded"]["seconds"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    (out_dir / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def sync(dev):
    """Wait for the card's queued work (nothing on the CPU)."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sharded_train_start(n_layers, B, S, dev):
    """launch.train's start state for phi4-mini cut to `n_layers`: the
    seed-0 model, its AdamW config for SHARDED_TRAIN's steps, and the
    data stream's first batch (B, S) on `dev`."""
    import torch
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as opt
    cfg = train.scale_config(configs.get("phi4-mini-3.8b"),
                             n_layers=n_layers)
    model = transformer.Transformer(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    steps_ = SHARDED_TRAIN[3]
    ocfg = opt.AdamWConfig(lr=3e-4, total_steps=steps_,
                           warmup_steps=max(steps_ // 20, 5))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipeline._batch_at(
        pipeline.DataConfig(vocab_size=cfg.vocab_size, batch=B, seq=S,
                            seed=0), 0).items()}
    return cfg, model, ocfg, batch


def recording_attention_shapes():
    """(patch, shapes): while the patch is active, each launch of the
    attention kernel appends its q, k and v shapes to `shapes`."""
    from repro_torch.kernels import ops
    shapes = []
    real = ops._attend

    def rec(q, k, v, *a):
        if q.is_cuda:
            shapes.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return real(q, k, v, *a)
    return mock.patch.object(ops, "_attend", rec), shapes


def fp32_activations():
    """A patch: while it is active, the models read the embedding in fp32
    instead of bf16, so the activations and every product after it run
    in fp32 (the weights are fp32 masters)."""
    import torch
    from repro_torch.models import transformer
    real = transformer.Transformer.weight

    def weight(self, name, dtype):
        return real(self, name, torch.float32 if name == "embed" else dtype)
    return mock.patch.object(transformer.Transformer, "weight", weight)


def sharded_prompt(cfg, B, S, dev) -> dict:
    """Phase 32(c)'s prompt: (B, S) tokens from seed 1."""
    import torch
    return {"tokens": torch.randint(
        0, cfg.vocab_size, (B, S), device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))}


def sharded_fp32_witness(rank, mesh, dev, out_dir) -> dict:
    """The witness of (c)'s drift at SHARDED_TP's depth: the prefill with
    fp32 activations on the einsum path (fp32_activations), world 1's
    run on every rank recording each layer's input and output, then the
    sharded run on `mesh` twice: free-running (its logits saved as
    rank<r>_logits_fp32.npy beside rank 0's plain_logits_fp32.npy) and
    teacher-forced, each layer fed world 1's input for it.  Returns the
    teacher-forced run's max |sharded - world 1| and max |world 1| of
    each layer's output and of the logits, and the logits' dtype."""
    import numpy as np
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.runtime import sharding, steps
    layers, B, S = SHARDED_TP
    cfg, model, _, _ = sharded_train_start(layers, B, S, dev)
    inputs = sharded_prompt(cfg, B, S, dev)
    seen: list = []
    res: dict = {"layers": []}

    def record(mod, args, out):
        seen.append((args[0].detach().clone(), out[0].detach().clone()))

    def feed(i):
        def hook(mod, args):
            x = args[0]
            return (distribute_tensor(seen[i][0], x.device_mesh,
                                      x.placements, src_data_rank=None),
                    ) + args[1:]
        return hook

    def check(i):
        def hook(mod, args, out):
            got, want = out[0].full_tensor(), seen[i][1]
            res["layers"].append((float((got - want).abs().max()),
                                  float(want.abs().max())))
        return hook

    with fp32_activations():
        hooks = [b.register_forward_hook(record) for b in model.blocks]
        plain, _ = steps.make_prefill_step(cfg, impl="einsum")(model, inputs)
        for h in hooks:
            h.remove()
        if rank == 0:
            np.save(out_dir / "plain_logits_fp32.npy",
                    plain.float().cpu().numpy())
        st = sharding.Strategy(mesh, "2d", False)
        st.distribute(model)
        prefill = steps.make_prefill_step(cfg, impl="einsum", strategy=st)
        with host_staged():
            logits = prefill(model, inputs)[0].full_tensor()
            np.save(out_dir / f"rank{rank}_logits_fp32.npy",
                    logits.float().cpu().numpy())
            hooks = [h for i, b in enumerate(model.blocks)
                     for h in (b.register_forward_pre_hook(feed(i)),
                               b.register_forward_hook(check(i)))]
            forced = prefill(model, inputs)[0].full_tensor()
            for h in hooks:
                h.remove()
    res["logits"] = (float((forced - plain).abs().max()),
                     float(plain.abs().max()))
    res["dtype"] = str(forced.dtype)
    del model, seen, plain, logits, forced, st
    torch.cuda.empty_cache()
    return res


def sharded_rank_part(rank, world, dev, out_dir) -> dict:
    """Phase 32(c) on one rank of the gloo world: phi4-mini's serving
    prefill at full width (SHARDED_TP: layers, batch, prompt) under "2d" on
    a 1 x world "model" mesh, and one train step (SHARDED_FSDP) under
    "fsdp" on a world x 1 "data" mesh, the batch's rows split over the
    ranks; rank 0 also runs both without a strategy.  gloo gets the
    collectives of SHARDED_STAGED on pinned host copies (host_staged).
    The logits go to out_dir as rank<r>_logits.npy; returns the counts, shapes, losses and
    each parameter's checksum after the step."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train
    from repro_torch.runtime import sharding, steps
    from repro_torch.train import optimizer as opt
    out: dict = {}
    layers, B, S = SHARDED_TP
    mesh = lmesh.make_host_mesh((1, world), ("data", "model"),
                                device_type=dev.type)
    # the prefill at 1 layer (bounded against world 1) and at `layers`
    # (timed, its launches and local shapes recorded, its drift reported)
    for depth in (1, layers):
        cfg, model, _, _ = sharded_train_start(depth, B, S, dev)
        inputs = sharded_prompt(cfg, B, S, dev)
        if rank == 0:
            logits, _ = steps.make_prefill_step(cfg, impl="kernel")(model,
                                                                 inputs)
            np.save(out_dir / f"plain_logits_{depth}.npy",
                    logits.float().cpu().numpy())
            del logits, _
        st = sharding.Strategy(mesh, "2d", False)
        st.distribute(model)
        staged = host_staged()
        patch, shapes = recording_attention_shapes()
        prefill = steps.make_prefill_step(cfg, impl="kernel", strategy=st)
        with staged, patch:
            ops.FLASH_ATTENTION_LAUNCHES = 0
            sync(dev)
            t0 = time.perf_counter()
            logits, caches = prefill(model, inputs)
            full = logits.full_tensor()
            sync(dev)
            out["prefill_s"] = time.perf_counter() - t0
            out["launches"] = ops.FLASH_ATTENTION_LAUNCHES
        np.save(out_dir / f"rank{rank}_logits_{depth}.npy",
                full.float().cpu().numpy())
        out["shapes"] = sorted(set(shapes))
        out["staged_calls"], out["staged_s"] = staged.calls, staged.seconds
        del model, logits, caches, full, st
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["witness"] = sharded_fp32_witness(rank, mesh, dev, out_dir)
    out["witness_s"] = time.perf_counter() - t0

    layers, B, S = SHARDED_FSDP
    with train.reproducible(dev):
        if rank == 0:
            cfg, model, ocfg, batch = sharded_train_start(layers, B, S, dev)
            state = opt.adamw_init(dict(model.named_parameters()))
            _, _, m = steps.make_train_step(cfg, ocfg)(model, state, batch)
            out["plain_loss"] = float(m["loss"])
            del model, state
        cfg, model, ocfg, batch = sharded_train_start(layers, B, S, dev)
        mesh = lmesh.make_host_mesh((world, 1), ("data", "model"),
                                    device_type=dev.type)
        st = sharding.Strategy(mesh, "fsdp", False)
        st.distribute(model)
        state = opt.adamw_init(dict(model.named_parameters()))
        step = steps.make_train_step(cfg, ocfg, strategy=st)
        staged = host_staged()
        with staged:
            sync(dev)
            t0 = time.perf_counter()
            _, _, m = step(model, state, batch)
            sync(dev)
            out["train_s"] = time.perf_counter() - t0
            out["train_staged_calls"] = staged.calls
            out["train_staged_s"] = staged.seconds
            out["rows"] = int(st.shard_batch(batch)["tokens"].to_local()
                              .shape[0])
            out["loss"] = float(m["loss"])
            out["grad_norm"] = float(m["grad_norm"])
            out["checksum"] = [
                int(p.full_tensor().detach().view(torch.int32)
                    .sum(dtype=torch.int64))
                for p in model.parameters()]
    del model, state
    torch.cuda.empty_cache()
    return out


def shard_phase(card, dev, p_full, lp_full, phase4, phase5, library_ms):
    """Phase 30 and 31.  SHARD_WORLD ranks that share the card over gloo
    (processes of this script's own) start first, for parts (c) and (d)
    and phase 31's 2-rank sync.  While they start up, this process runs
    parts (a), (b) and (d) and phase 31 at world 1; then it lets the
    ranks go on (they wait for it before their solves and timings, so
    that no two processes' kernels share the card) and checks their
    results.  Returns the two `kernels` entries of the split step, and
    the ranks' results (phase 32(c)'s among them)."""
    with shard_ranks(SHARD_WORLD) as collect:
        return _shard_phase(card, dev, p_full, lp_full, phase4, phase5,
                            library_ms, collect)


def sharded_phase(card, dev, ranks, helpers: dict) -> dict:
    """Phase 32: the sharded steps.  (a) and (b) at world 1 over NCCL on a
    1 x 1 ("data", "model") mesh; (c) the results of phase 30's ranks
    (sharded_rank_part); (d) the dry-run cells of their helper processes
    (`helpers`, from start_helpers); and the attention kernel
    timed at the TP-local shape of (c)'s ranks beside SDPA.  Returns the
    attention launches of (b) and (c) and the timed numbers."""
    with one_rank_world("nccl" if dev.type == "cuda" else "gloo"):
        out = sharded_world1(card, dev)
    out.update(sharded_ranks_report(ranks))
    out.update(sharded_dryrun(helpers))
    out.update(sharded_attention_times(card, dev))
    return out


@contextlib.contextmanager
def one_rank_world(backend):
    """A one-rank world joined through a FileStore (no port)."""
    import torch.distributed as dist
    store = tempfile.mkdtemp(prefix="chip-smoke-world1-")
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(store, "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def sharded_world1(card, dev) -> dict:
    """Phase 32 (a) and (b) at world 1 (module docstring)."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import serve, train
    from repro_torch.runtime import sharding, steps
    from repro_torch.train import optimizer as opt
    mesh = lmesh.make_host_mesh((1, 1), ("data", "model"),
                                device_type=dev.type)
    layers, B, S, _ = SHARDED_TRAIN
    say(f"[32] the sharded steps on the card ({card}): torch "
        f"{torch.__version__}, DTensor on a 1 x 1 (data, model) mesh over "
        f"{'NCCL' if dev.type == 'cuda' else 'gloo'}")
    say(f"  (a) one train step of phi4-mini-3.8b at full width, {layers} "
        f"layers, batch {B} x {S}, from phase 28's start state: unsharded, "
        f"then under fsdp and 2d")
    with train.reproducible(dev):
        cfg, model, ocfg, batch = sharded_train_start(layers, B, S, dev)
        state = opt.adamw_init(dict(model.named_parameters()))
        sync(dev)
        t0 = time.perf_counter()
        _, _, want = steps.make_train_step(cfg, ocfg)(model, state, batch)
        sync(dev)
        plain_s = time.perf_counter() - t0
        ref = {n: p.detach() for n, p in model.named_parameters()}
        del model, state
        say(f"    unsharded: loss {float(want['loss'])!r} grad norm "
            f"{float(want['grad_norm'])!r}; {plain_s * 1e3:.1f} ms")
        for kind in ("fsdp", "2d"):
            cfg, model, ocfg, batch = sharded_train_start(layers, B, S, dev)
            st = sharding.Strategy(mesh, kind, False)
            st.distribute(model)
            state = opt.adamw_init(dict(model.named_parameters()))
            step = steps.make_train_step(cfg, ocfg, strategy=st)
            sync(dev)
            t0 = time.perf_counter()
            _, _, got = step(model, state, batch)
            sync(dev)
            wall = time.perf_counter() - t0
            same = all(torch.equal(got[k], want[k]) for k in want)
            differ = [n for n, p in model.named_parameters()
                      if not torch.equal(p.to_local(), ref[n])]
            say(f"    {kind}: loss {float(got['loss'])!r} grad norm "
                f"{float(got['grad_norm'])!r}; {wall * 1e3:.1f} ms; "
                f"metrics bitwise the unsharded step's: {same}; updated "
                f"parameters differing: {len(differ)} of {len(ref)}"
                + (f" ({', '.join(differ[:4])})" if differ else ""))
            require(abs(float(got["loss"]) - float(want["loss"]))
                    < SHARDED_LOSS_TOL, f"(a) {kind}: loss off the "
                    f"unsharded step's by {SHARDED_LOSS_TOL} or more")
            require(same and not differ, f"(a) {kind}: not bitwise the "
                    f"unsharded step")
            del model, state, step
            torch.cuda.empty_cache()
        del ref
        torch.cuda.empty_cache()

    n = SHARDED_DECODE
    B, P = SHARDED_SERVE
    cfg = configs.get("phi4-mini-3.8b")
    say(f"  (b) {cfg.name}'s serving prefill under 2d at full width "
        f"({cfg.n_layers} layers, batch {B}, prompt {P}, impl=kernel) and "
        f"{n} decode steps, against the unsharded ones")
    model, inputs = serve.build(cfg, B, P, 0, dev)
    runs = {}
    for name, st in (("plain", None),
                     ("2d", sharding.Strategy(mesh, "2d", False))):
        if st is not None:
            st.distribute(model)
        ops.FLASH_ATTENTION_LAUNCHES = 0
        prefill = steps.make_prefill_step(cfg, impl="kernel",
                                          max_len=P + n, strategy=st)
        decode = steps.make_decode_step(cfg, impl="kernel", strategy=st)
        whole = (lambda t: t.full_tensor()) if st else (lambda t: t)
        sync(dev)
        t0 = time.perf_counter()
        logits, caches = prefill(model, inputs)
        sync(dev)
        prefill_s = time.perf_counter() - t0
        launches = ops.FLASH_ATTENTION_LAUNCHES
        run = {"prefill": whole(logits),
               "caches": [{k: whole(c[k]).clone() for k in ("k", "v")}
                          for c in caches], "steps": [], "tokens": []}
        tok = run["prefill"][:, -1:].argmax(-1)
        t0 = time.perf_counter()
        for i in range(n):
            logits, caches = decode(model, caches, tok, P + i)
            run["steps"].append(whole(logits))
            tok = run["steps"][-1].argmax(-1)
            run["tokens"].append(tok)
        sync(dev)
        run["decode_s"] = time.perf_counter() - t0
        run["prefill_s"], run["launches"] = prefill_s, launches
        runs[name] = run
        del logits, caches
    a, b = runs["plain"], runs["2d"]
    same_prefill = torch.equal(a["prefill"], b["prefill"])
    same_caches = all(torch.equal(x[k], y[k]) for x, y in
                      zip(a["caches"], b["caches"]) for k in ("k", "v"))
    same_steps = all(torch.equal(x, y) for x, y in zip(a["steps"],
                                                       b["steps"]))
    same_tokens = all(torch.equal(x, y) for x, y in zip(a["tokens"],
                                                        b["tokens"]))
    say(f"    prefill {b['prefill_s'] * 1e3:.1f} ms under 2d "
        f"({a['prefill_s'] * 1e3:.1f} ms unsharded); {n} decode steps "
        f"{b['decode_s'] * 1e3:.1f} ms ({a['decode_s'] * 1e3:.1f} ms); "
        f"flash_attention launches {b['launches']} through the DTensor "
        f"wrapper ({a['launches']} unsharded)")
    say(f"    bitwise the unsharded run: last-token logits {same_prefill}, "
        f"caches {same_caches}, decode logits {same_steps}; tokens "
        f"identical {same_tokens}")
    require(b["launches"] == cfg.n_layers, f"(b) launched the attention "
            f"kernel {b['launches']} times, expected {cfg.n_layers}")
    require(same_prefill and same_caches and same_steps and same_tokens,
            "(b) the sharded serving run differs from the unsharded one")
    launches = b["launches"]
    del model, inputs, runs, a, b
    torch.cuda.empty_cache()
    return {"serve_launches": launches}


def sharded_ranks_report(ranks) -> dict:
    """Phase 32(c): the ranks' sharded prefill and train step."""
    import numpy as np
    out_dir = pathlib.Path(ranks[0]["dir"])
    layers, B, S = SHARDED_TP
    res = [r["sharded"] for r in ranks]
    say(f"  (c) {len(ranks)} ranks sharing the card over gloo (its "
        f"all-gathers and all-to-alls staged through pinned host "
        f"memory): phi4-mini-3.8b at full "
        f"width, {layers} layers, prefill batch {B} x {S} under 2d on a "
        f"1 x {len(ranks)} model mesh; a train step of "
        f"{SHARDED_FSDP[0]} layers, batch {SHARDED_FSDP[1]} x "
        f"{SHARDED_FSDP[2]} under fsdp on a {len(ranks)} x 1 data mesh")
    # one bf16 place at the largest magnitude `top`
    def place(top):
        return 2.0 ** (np.floor(np.log2(top)) - 7)
    err, scale = {}, {}
    for tag in ("1", str(layers), "fp32"):
        logits = [np.load(out_dir / f"rank{r}_logits_{tag}.npy")
                  for r in range(len(ranks))]
        plain = np.load(out_dir / f"plain_logits_{tag}.npy")
        require(all(np.array_equal(x, logits[0]) for x in logits),
                f"(c) the ranks' logits differ ({tag})")
        err[tag] = float(np.abs(logits[0] - plain).max())
        scale[tag] = place(np.abs(plain).max())
    deep = str(layers)
    say(f"    prefill: local attention shapes {res[0]['shapes']}; "
        f"launches {[r['launches'] for r in res]}; "
        f"{max(r['prefill_s'] for r in res):.3f} s (slower rank; "
        f"{res[0]['staged_calls']} staged collectives, "
        f"{res[0]['staged_s']:.3f} s); logits equal on both ranks; max "
        f"|sharded - unsharded| at 1 layer {err['1']:.6f} against one bf16 "
        f"place {scale['1']:.6f}; at {layers} layers {err[deep]:.6f} "
        f"(place {scale[deep]:.6f}; reported, the witness below bounds "
        f"{layers} layers)")
    w = res[0]["witness"]
    worst = max(e / place(top) for e, top in w["layers"] + [w["logits"]])
    say(f"    the witness ({w['dtype']} activations on the einsum path, "
        f"{max(r['witness_s'] for r in res):.3f} s, slower rank): "
        f"free-running, {layers} layers drift {err['fp32']:.6f} off world "
        f"1 (place {scale['fp32']:.6f}): a rounding apart, amplified "
        f"layer by layer by this random-weight model's attention; "
        f"teacher-forced (each layer fed world 1's input), max |sharded - "
        f"world 1| / max |world 1| a layer "
        + ", ".join(f"{e:.3e}/{top:.4g}" for e, top in w["layers"])
        + f", logits {w['logits'][0]:.3e}/{w['logits'][1]:.4g}: at most "
        f"{worst:.3e} of one bf16 place (a wrong head map or collective "
        f"would be off by its whole magnitude)")
    require(err["1"] <= scale["1"], "(c) the sharded logits at 1 layer are "
            "more than one bf16 place off the unsharded ones")
    require(w["dtype"] == "torch.float32" and len(w["layers"]) == layers,
            "(c) the witness did not run every layer in fp32")
    require(worst <= 1.0, f"(c) a teacher-forced fp32 layer of the "
            f"sharded prefill is more than one bf16 place off world 1's")
    require(all(r["launches"] == layers for r in res),
            "(c) a rank did not launch the attention kernel once a layer")
    loss_err = abs(res[0]["loss"] - res[0]["plain_loss"])
    same_params = all(r["checksum"] == res[0]["checksum"] for r in res)
    say(f"    train step: loss {res[0]['loss']!r} (world 1 "
        f"{res[0]['plain_loss']!r}, |diff| {loss_err:.3e}); grad norm "
        f"{res[0]['grad_norm']!r}; rows a rank {res[0]['rows']}; "
        f"{max(r['train_s'] for r in res):.3f} s (slower rank; "
        f"{res[0]['train_staged_calls']} staged collectives, "
        f"{res[0]['train_staged_s']:.3f} s); every parameter's full "
        f"tensor equal on both ranks: {same_params}; the ranks' part "
        f"{max(r['seconds'] for r in res):.1f} s")
    require(loss_err < SHARDED_LOSS_TOL, "(c) the sharded train step's "
            "loss is off the world-1 step's")
    require(same_params, "(c) the ranks' parameters differ after the step")
    return {"rank_launches": sum(r["launches"] for r in res)}


def train_model_flops(arch: str, seq: int, tokens: int, ranks: int) -> float:
    """A train step's flops a rank as tests/test_torch_dryrun.py counts
    them: 8 a weight a token through the layers (2 forward, 2 remat, 4
    backward), attention's four S x S products 4 times a sequence, and 6
    a weight a token for the unembedding, over `ranks`."""
    from repro_torch import configs
    cfg = configs.get(arch)
    d, hq, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         cfg.d_ff)
    layer = 2 * d * hq * hd + 2 * d * hkv * hd + 3 * d * f
    attention = 4 * (4 * seq * seq * hq * hd) * (tokens // seq)
    return (cfg.n_layers * (8 * layer * tokens + attention)
            + 6 * d * cfg.padded_vocab(1) * tokens) / ranks


def moe_train_model_flops(arch: str, tp: int, seq: int, tokens: int,
                          ranks: int, n_layers: int | None = None) -> float:
    """An MoE train step's flops a rank (tests/test_torch_moe_dryrun.py
    holds the dry run's cells to it too): 8 a weight a token for the
    dense weights (attention, router, shared expert), the experts' three
    products at their capacity (groups x padded experts x C slots: the
    dispatch pads every expert's queue), the dispatch (3 products:
    forward, remat, the tokens' gradient) and combine (4: its gradient
    reaches the gates) over groups x tokens x slots x d_model,
    attention's S x S products, and 6 a weight a token for the
    unembedding; over the config's layers, or `n_layers`."""
    from repro_torch import configs
    from repro_torch.models import moe
    cfg = configs.get(arch)
    m = cfg.moe
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    ep = moe.padded_experts(m, tp)
    dense = 2 * d * hq * hd + 2 * d * hkv * hd + d * ep
    if m.n_shared:
        dense += 3 * d * m.d_shared + d
    g = m.group_size
    cap = max(math.ceil(g * m.top_k * m.capacity_factor / m.n_experts),
              m.top_k)
    slots = (tokens // g) * ep * cap
    layer = (8 * dense * tokens + 8 * 3 * d * m.d_expert * slots
             + 2 * (3 + 4) * slots * g * d
             + 4 * (4 * seq * seq * hq * hd) * (tokens // seq))
    return ((n_layers or cfg.n_layers) * layer
            + 6 * d * cfg.padded_vocab(tp) * tokens) / ranks


def dryrun_cells(cells) -> dict:
    """A helper's job: each train_4k cell (arch, strategy) of the dry run
    at 16 x 16 on the host CPU (meta tensors, a fake world), one after
    another, by cell with its largest ops, torch's release and its
    wall."""
    import torch
    from repro_torch.launch import dryrun
    os.nice(10)
    torch.set_num_threads(1)
    res = {}
    for arch, strategy in cells:
        t0 = time.perf_counter()
        by_op: dict = {}
        r = dryrun.run_cell(arch, SHARDED_DRYRUN[1], multi_pod=False,
                            strategy_kind=strategy, by_op=by_op)
        res[arch, strategy] = {**dataclasses.asdict(r),
                               "by_op": list(by_op.items()),
                               "torch": torch.__version__,
                               "wall": time.perf_counter() - t0}
    return res


def sharded_dryrun(helpers: dict) -> dict:
    """Phase 32(d): the dry run's train_4k cells at 16 x 16 (phi4-mini
    under its default strategy; granite-moe and qwen2-moe under "auto"
    and fsdp), run by a helper process started at the top: each ok, with
    all-gathers and reduce-scatters counted, its flops a rank within
    DRYRUN_FLOP_RTOL of the model's count."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    out = {}
    cells = helper_result(helpers, "dryrun")
    for arch, strategy in DRYRUN_CELLS:
        res = cells[arch, strategy]
        coll = res["collectives"] or {}
        cfg = configs.get(arch)
        kind = (dryrun.pick_strategy_kind(cfg, "train")
                if strategy == "auto" else strategy)
        say(f"  (d) the dry run, {arch} x {res['shape']} under {strategy} "
            f"({kind}) at {res['mesh']} (torch {res['torch']}): ok "
            f"{res['ok']} in {res['wall']:.1f} s in the helper; flops a "
            f"rank {res['flops_per_device']:.6g}, bytes a rank "
            f"{res['bytes_per_device']:.6g}, collectives "
            f"{coll.get('_counts')}, memory {res['memory']}; params "
            f"{res['params_total']:.6g} ({res['params_active']:.6g} "
            f"active)")
        require(res["ok"], f"(d) the dry-run cell {arch} x {strategy} "
                           f"failed: {res['error'][:2000]}")
        spec = dryrun.SHAPES[res["shape"]]
        tp = 16 if kind == "2d" else 1
        want = (moe_train_model_flops(arch, tp, spec["seq"], res["tokens"],
                                      256) if cfg.moe else
                train_model_flops(arch, spec["seq"], res["tokens"], 256))
        ratio = res["flops_per_device"] / want
        say(f"    the model's count {want:.6g} flops a rank; the cell's "
            f"{ratio:.4f} of it (within {DRYRUN_FLOP_RTOL:.0%} required)")
        for op, flops in res["by_op"][:DRYRUN_TOP_OPS]:
            say(f"      {flops:.6g} flops a rank: {op}")
        require(res["flops_per_device"] > 0
                and coll["_counts"].get("all-gather", 0) > 0
                and coll["_counts"].get("reduce-scatter", 0) > 0,
                f"(d) the dry-run cell {arch} x {strategy} counted no "
                f"flops, or no all-gather or reduce-scatter")
        require(abs(ratio - 1.0) <= DRYRUN_FLOP_RTOL,
                f"(d) the dry-run cell {arch} x {strategy}'s flops a rank "
                f"{res['flops_per_device']:.6g} are {ratio:.4f} of the "
                f"model's {want:.6g}")
        out[arch, strategy] = (res["flops_per_device"], ratio, res["wall"])
    say(f"    (d) waited {time.perf_counter() - t0:.1f} s for the cells' "
        f"helper")
    return {"dryrun": out}


def sharded_attention_times(card, dev) -> dict:
    """Row 2e: the attention kernel at (c)'s TP-local shape beside SDPA,
    and its bound."""
    import torch
    from repro_torch.kernels import ops
    layers, B, S = SHARDED_TP
    H, Hkv, hd = 24 // SHARD_WORLD, 8 // SHARD_WORLD, 128
    q, k, v = fa_inputs(32, B, S, H, Hkv, hd, torch.bfloat16, dev)
    err = compare_attention("TP-local (row 2e)", q, k, v, 0, 0.0, True)
    ms = sorted(time_events(lambda: ops.flash_attention(q, k, v), 10)
                for _ in range(3))[1]
    plain_ms = time_events(lambda: fa_plain(q, k, v, 0, 0.0), 3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_events(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=True), 10)
    bound_ms, bound_by, _, _ = attention_bound(B, S, H, Hkv, hd, 0, 2)
    say(f"    the attention kernel at a rank's shape q ({B}, {S}, {H}, "
        f"{hd}), k/v ({B}, {S}, {Hkv}, {hd}) bf16 ({card}): "
        f"max|kernel-plain| {err:.3e}; {ms:.6f} ms "
        f"(median of 3 runs of 10); plain {plain_ms:.6f} ms; SDPA "
        f"{lib_ms:.6f} ms; bound {bound_ms:.6f} ms ({bound_by}); "
        f"{ms / bound_ms:.3f}x its bound, {ms / lib_ms:.3f}x SDPA")
    del q, k, v, qt, kt, vt
    return {"tp_ms": ms, "tp_plain_ms": plain_ms, "tp_lib_ms": lib_ms,
            "tp_bound_ms": bound_ms, "tp_err": err}


def _shard_phase(card, dev, p_full, lp_full, phase4, phase5, library_ms,
                 collect):
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import solver
    from repro_torch.kernels import build, ops, pdhg_spmv
    nnz = len(lp_full.val)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    say(f"[30] row-sharded PDHG on the card ({card}); {SHARD_WORLD} ranks "
        f"started for part (c)")
    step_ptxas = split_step_ptxas(build.BUILD_INFO["pdhg_burst.cu"]["log"])
    for line in step_ptxas:
        say(f"    ptxas: {line}")
    require(len(step_ptxas) == 2 or not build.BUILD_INFO["pdhg_burst.cu"]
            ["log"], f"expected the split step's 2 templates in the ptxas "
                     f"log, found {len(step_ptxas)}")
    require(all("spill stores 0 B" in t for t in step_ptxas),
            "the split step spills registers")
    say(f"    split step grid: {ops.split_max_blocks('fp32', dev)} blocks "
        f"(fp32), {ops.split_max_blocks('bf16', dev)} (bf16) of 512 fit "
        f"at once on {sms} SMs")
    say("  (a) the split step against the plain body in the kernel's "
        "order (one process holding every shard: a burst one launch)")
    errs = {"fp32": [], "bf16": []}
    differs = []
    for shards, precisions in SPLIT_CASES:
        op, args = sharded_args(lp_full, shards, dev)
        for precision in precisions:
            for iters in SPLIT_ITERS:
                err, d = check_split("fat-tree-k16", op, args, iters,
                                     precision, sms)
                errs[precision].append(err)
                differs.append(d)
    say(f"    the plain body in torch's order differs from the split "
        f"step bitwise in {sum(differs)} of {len(differs)} cases, so "
        f"the bitwise check can fail")
    require(any(differs), "the split step's bitwise check cannot fail")

    store = tempfile.mkdtemp(prefix="chip-smoke-nccl-")
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(store, "store"), 1), rank=0, world_size=1)
    group = dist.group.WORLD
    try:
        say("  (b) the sharded driver at world 1 over NCCL against the "
            "fused burst")
        reset_split_counts()
        # the solve_lp ladder (4000 iterations, doubled up to 3 times); the
        # bf16 case its first rung only (bf16 runs the whole ladder)
        for obj, precision, rungs in (("energy", "fp32", 3),
                                      ("time", "fp32", 3),
                                      ("energy", "bf16", 0)):
            lp, _ = solver.build_routing_lp(p_full, obj)
            tol = 1e-4 * max(float(np.abs(lp.b).max(initial=0.0)), 1.0)
            before = (ops.PDHG_SPLIT_LAUNCHES, ops.PDHG_SPLIT_GRAPH_REPLAYS)
            t0 = time.perf_counter()
            shard = solver._solve_lp_pallas_sharded(
                lp, 4000, tol, rungs, None, None, 1, dev, precision)
            wall = time.perf_counter() - t0
            launched = ops.PDHG_SPLIT_LAUNCHES - before[0]
            replays = ops.PDHG_SPLIT_GRAPH_REPLAYS - before[1]
            t0 = time.perf_counter()
            fused = solver._solve_lp_ell(lp, 4000, tol, rungs, None, None,
                                         dev, precision)
            fused_wall = time.perf_counter() - t0
            same = (np.array_equal(shard.x, fused.x)
                    and np.array_equal(shard.y, fused.y)
                    and shard.iterations == fused.iterations)
            obj_s, obj_f = float(lp.c @ shard.x), float(lp.c @ fused.x)
            say(f"    {obj:6s} {precision}: iters={shard.iterations} "
                f"primal={shard.primal_residual:.3e} objective "
                f"{obj_s!r} (fused {obj_f!r}); x, y bitwise the fused "
                f"burst: {same}; {launched} split launches, {replays} of "
                f"the graph's replays among them; wall {wall:.3f} s "
                f"(fused {fused_wall:.3f} s)")
            require(same and obj_s == obj_f,
                    f"world-1 sharded driver {obj} {precision} differs "
                    f"from the fused burst")
        w1 = (ops.PDHG_SPLIT_LAUNCHES, ops.PDHG_SPLIT_BF16_LAUNCHES)
        w1_replays = ops.PDHG_SPLIT_GRAPH_REPLAYS
        say(f"    split launches on this part's solves: {w1[0]} "
            f"(bf16 {w1[1]}), {w1_replays} graph replays; sharded bursts "
            f"{ops.PDHG_SHARDED_CALLS}")
        require(w1[0] > 0 and w1[1] > 0 and ops.PDHG_SHARDED_CALLS > 0,
                "part (b) did not go through the split step")
        require(w1_replays > 0, "part (b)'s NCCL ladder replayed no graph")
        op1, args1 = sharded_args(lp_full, 1, dev)
        x0, y0 = args1[12], args1[13]
        for precision in ("fp32", "bf16"):
            graph = split_plan(group, op1, args1, precision)
            eager = split_plan(group, op1, args1, precision)
            eager.capture = False
            alone = split_plan(None, op1, args1, precision)
            for iters in SPLIT_ITERS:
                r0 = ops.PDHG_SPLIT_GRAPH_REPLAYS
                got = [t.clone() for t in graph(x0, y0, iters)]
                replays = ops.PDHG_SPLIT_GRAPH_REPLAYS - r0
                want = eager(x0, y0, iters)
                one = alone(x0, y0, iters)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                same_one = all(torch.equal(a, b) for a, b in zip(got, one))
                say(f"    {precision} burst of {iters} over NCCL, "
                    f"{replays} graph replays: bitwise the eager step "
                    f"launches: {same}; the burst without a collective: "
                    f"{same_one}")
                require(replays == iters // 2 and same and same_one,
                        f"the graph-replayed {precision} burst of {iters} "
                        f"differs from the eager one")

        say(f"  (d) times at world 1, flagship LP ({card})")
        op_f, args_f = lp_burst_args(lp_full, dev)
        kw_f = layout(op_f, dev)
        n = SHARD_TIME_ITERS
        times = {}
        for precision in ("fp32", "bf16"):
            plans = {"graph": split_plan(group, op1, args1, precision),
                     "eager": split_plan(group, op1, args1, precision),
                     "alone": split_plan(None, op1, args1, precision)}
            plans["eager"].capture = False
            for name, plan in plans.items():
                plan(x0, y0, n)                  # its graph captured
                times[name, precision] = sorted(time_events(
                    lambda: plan(x0, y0, n), 1) / n for _ in range(3))[1]
            times["fused", precision] = sorted(time_events(
                lambda: ops.pdhg_burst(*args_f, iters=n,
                                       precision=precision, **kw_f), 1) / n
                for _ in range(3))[1]
            kw_p = dict(row_meta=op1.row_meta, col_meta=op1.col_meta,
                        iters=SHARD_PLAIN_ITERS, precision=precision)
            times["plain", precision] = time_events(
                lambda: pdhg_spmv.pdhg_update_burst_sharded(
                    args1[12], args1[13], *args1[:12], **kw_p),
                1) / SHARD_PLAIN_ITERS
            del plans
        parts = torch.zeros((1, op1.n_pad), device=dev)
        gather = ops.ShardGather(group, (1, op1.n_pad), torch.float32, dev)
        coll = time_events(lambda: [gather(parts) for _ in range(n)], 1) / n
        for precision in ("fp32", "bf16"):
            t = {k: times[k, precision]
                 for k in ("graph", "eager", "alone", "fused", "plain")}
            say(f"    split {precision} over NCCL {t['graph']:.6f} ms/iter "
                f"(the graph of two iterations replayed, median of 3 "
                f"bursts of {n}); the same step launched eagerly with the "
                f"collective between {t['eager']:.6f}; without a "
                f"collective (one launch a burst) {t['alone']:.6f}, "
                f"{t['alone'] / t['fused']:.3f}x the fused burst's "
                f"{t['fused']:.6f}; plain {t['plain']:.6f} ms/iter")
        say(f"    the collective (NCCL all_gather of {op1.n_pad} floats, "
            f"world 1, eager) {coll:.6f} ms, "
            f"{coll / times['eager', 'fp32']:.1%} of an eager split fp32 "
            f"iteration")
        for precision in ("fp32", "bf16"):
            for label, grp in (("no collective (group=None)", None),
                               ("over NCCL", group)):
                own = split_device_ms(grp, op1, args1, precision)
                k, k_ev = own["cupti"], own["events"]
                times["kernels", precision, grp is None] = k
                times["stream", precision, grp is None] = k_ev
                it = times["graph" if grp is not None else "alone",
                           precision]
                cupti = (f"not measured (the profiler kept "
                         f"{own['seen']} of its {own['launched']} launches)"
                         if k is None else
                         f"{k:.6f} ms an iteration, {k / it:.1%} of the "
                         f"iteration's {it:.6f} ms")
                say(f"    split step {precision}, {label}: its own "
                    f"device time (CUPTI's kernel durations over a burst "
                    f"of {SPLIT_OWN_ITERS}) {cupti}; {k_ev:.6f} ms a step "
                    f"launch (CUDA events over {SPLIT_OWN_REPS} launches "
                    f"queued behind a sleep: the stream's time a launch "
                    f"with the host ahead); the CSR pair "
                    f"{library_ms:.6f} ms")

        t_phase = time.perf_counter()
        sync_phase(card, dev)
        say(f"    phase 31 at world 1 took {time.perf_counter() - t_phase:.1f}"
            f" s")
    finally:
        dist.destroy_process_group()

    # the host CPU's single-process model of the ranks' fixed burst
    op_c, args_c = sharded_args(lp_full, SHARD_WORLD, torch.device("cpu"))
    model = pdhg_spmv.pdhg_update_burst_sharded(
        args_c[12], args_c[13], *args_c[:12], order="kernel",
        **split_kw(op_c, torch.device("cpu"), SHARD_FIXED_ITERS, "fp32"))
    say(f"  (c) {SHARD_WORLD} ranks sharing the card over gloo (partials "
        f"staged through pinned host memory), processes of this script")
    ranks = collect()
    r0 = ranks[0]
    for k, run in r0["runs"].items():
        on_all = all(res["runs"][k]["x"] == run["x"]
                     and res["runs"][k]["schedule"] == run["schedule"]
                     for res in ranks)
        want = phase5 if k == "flagship" else phase4[k.split("#")[0]]
        got = {key: run[key] for key in want}
        ok = close(got, want, METRIC_RTOL)
        say(f"    {k:12s} E={run['energy_j']:.6f} J "
            f"M={run['completion_s']:.6f} s iters={run['iterations']} "
            f"wall={run['wall']:.3f} s cert="
            f"{'ok' if run['cert_ok'] else 'FAIL'}"
            f"; x and schedule the same on every rank: {on_all}; within "
            f"{METRIC_RTOL} of phase {5 if k == 'flagship' else 4}: "
            f"{ok}")
        require(on_all and run["cert_ok"] and ok,
                f"{k} at {SHARD_WORLD} ranks")
    a, b = r0["runs"]["spine-leaf"], r0["runs"]["spine-leaf#1"]
    same_twice = a["x"] == b["x"] and a["schedule"] == b["schedule"]
    fixed_twice = all(res["fixed_repeat"] for res in ranks)
    say(f"    spine-leaf solved twice: bitwise equal: {same_twice}; the "
        f"flagship's fixed burst of {SHARD_FIXED_ITERS} twice on every "
        f"rank: bitwise equal: {fixed_twice}")
    require(same_twice and fixed_twice, "two sharded runs differ")
    xs = [np.load(pathlib.Path(ranks[0]["dir"]) / f"rank{r}_x.npy")
          for r in range(SHARD_WORLD)]
    same_model = all(np.array_equal(x, model[0].numpy()) for x in xs)
    say(f"    x after {SHARD_FIXED_ITERS} iterations at {SHARD_WORLD} ranks "
        f"bitwise the host CPU's single-process model in the kernel's "
        f"order: {same_model}")
    require(same_model, "the sharded card run differs from the CPU's model")
    launches = sum(res["launches"] for res in ranks)
    say(f"    split launches on the ranks' solve_fast runs: "
        f"{[res['launches'] for res in ranks]}; fused burst launches "
        f"{[res['fused_launches'] for res in ranks]}")
    require(all(res["launches"] > 0 and res["fused_launches"] == 0
                for res in ranks),
            "the ranks' solves did not go through the split step alone")
    it = max(res["iter_ms"] for res in ranks)
    co = max(res["collective_ms"] for res in ranks)
    direct = max(res["direct_ms"] for res in ranks)
    say(f"  (d) at {SHARD_WORLD} ranks: {it:.6f} ms/iter (host clock over a "
        f"burst of {SHARD_RANK_TIME_ITERS}, slower rank); the collective "
        f"alone {co:.6f} ms ({co / it:.1%} of an iteration); gloo given "
        f"the CUDA tensors directly {direct:.6f} ms")
    say(f"[31] the scheduled sync at {SHARD_WORLD} ranks over gloo: "
        f"{r0['sync_buckets']} buckets in {r0['sync_slots']} slot groups, "
        f"{r0['sync_collectives']} collectives; max |synced - mean| "
        f"{max(res['sync_err'] for res in ranks):.3e} of scale "
        f"{r0['sync_scale']:.3e}; slot order kept: "
        f"{all(res['sync_order_ok'] for res in ranks)}")
    require(all(res["sync_err"] <= SYNC_RTOL * res["sync_scale"]
                and res["sync_order_ok"] for res in ranks),
            "the scheduled sync at 2 ranks is off the plain mean")

    entries = []
    for precision in ("fp32", "bf16"):
        bound_ms, bound_by = split_bound(op1, op_f, nnz,
                                         4 if precision == "fp32" else 2)
        n_launch = (w1[0] - w1[1] + launches) if precision == "fp32" \
            else w1[1]
        entries.append({
            "name": f"pdhg_split_step_"
                    f"{'f32' if precision == 'fp32' else 'bf16'}",
            "route": "cuda", "source": SOURCE, "replaces": SHARD_REPLACES,
            "launches": n_launch, "max_abs_err": max(errs[precision]),
            "ms": times["graph", precision],
            "plain_ms": times["plain", precision], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "eager_ms": times["eager", precision],
            "alone_ms": times["alone", precision],
            "fused_ms": times["fused", precision],
            "graph_replays": w1_replays,
            "kernels_ms": times["kernels", precision, False],
            "kernels_alone_ms": times["kernels", precision, True],
            "kernels_stream_ms": times["stream", precision, False]})
        say(f"    {entries[-1]['name']}: {times['graph', precision]:.6f} "
            f"ms/iter at world 1 over NCCL, bound {bound_ms:.6f} ms "
            f"({bound_by}), library {library_ms:.6f} ms (phase 6's CSR "
            f"pair)")
    return entries, ranks


@contextlib.contextmanager
def shard_ranks(world):
    """Start `world` processes of this script in --shard-rank mode and
    yield collect(): it tells them to go on past their set-up (the file
    `go` in their directory), waits for all (SHARD_TIMEOUT_S from the
    start) and returns their results in rank order.  Every process is
    gone when the block ends, whether collect() ran or the block
    raised."""
    out = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-shard-"))
    logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--shard-rank",
         str(r), "--shard-world", str(world), "--shard-dir", str(out)],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + SHARD_TIMEOUT_S

    def collect() -> list[dict]:
        (out / "go").touch()
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            pass
        results = []
        for r, p in enumerate(procs):
            path = out / f"rank{r}.json"
            if p.poll() != 0 or not path.exists():
                tail = (out / f"rank{r}.log").read_text()[-4000:]
                raise AssertionError(f"shard rank {r} exited with "
                                     f"{p.poll()}:\n{tail}")
            res = json.loads(path.read_text())
            res["dir"] = str(out)
            results.append(res)
        return results

    try:
        yield collect
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


def sync_phase(card, dev) -> None:
    """Phase 31 at world 1 (inside phase 30's NCCL world): the gradient
    tree of phi4-mini cut to GRAD_LAYERS layers, bucketed at
    GRAD_BUCKET_BYTES and planned by core.fabric.plan_collectives,
    synced over a (1, 1) mesh: bitwise the input, in the plan's slot
    order."""
    import torch
    from repro_torch import configs, tree
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.runtime import collectives
    cfg = train.scale_config(configs.get("phi4-mini-3.8b"),
                             n_layers=GRAD_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = transformer.Transformer(cfg, generator=gen, device=dev)
    grads = {n: torch.randn(p.shape, generator=gen, device=dev)
             for n, p in model.named_parameters()}
    del model
    leaves = [leaf for _, leaf in tree.flatten(grads)]
    nbytes = sum(leaf.numel() * leaf.element_size() for leaf in leaves)
    t0 = time.perf_counter()
    ids, plan = grad_plan(leaves, GRAD_BUCKET_BYTES, dev)
    plan_s = time.perf_counter() - t0
    mesh = lmesh.make_host_mesh((1, 1), ("data", "model"),
                                device_type="cuda")
    issued: list = []
    sync = collectives.make_scheduled_grad_sync(mesh, plan, ids, ("data",),
                                                issued=issued)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    synced = sync(grads)
    torch.cuda.synchronize()
    sync_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree.flatten(synced), tree.flatten(grads)))
    order_ok = check_issue_order(issued, plan)
    say(f"[31] the scheduled gradient all-reduce at world 1 over NCCL "
        f"({card}): phi4-mini-3.8b cut to {GRAD_LAYERS} layers, "
        f"{len(leaves)} leaves, {nbytes / 2**30:.2f} GiB; "
        f"{len(ids)} buckets at {GRAD_BUCKET_BYTES / 1e6:.0f} MB in "
        f"{len(plan.slot_order())} slot groups (plan {plan_s:.3f} s, "
        f"makespan {plan.completion_s * 1e3:.3f} ms); {len(issued)} "
        f"collectives in slot order: {order_ok}; synced bitwise the input: "
        f"{same}; sync {sync_s * 1e3:.1f} ms")
    require(same and order_ok and len(issued) >= len(leaves),
            "the scheduled sync at world 1 is not the identity in slot "
            "order")
    del grads, synced, leaves
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 33: the COO lowering (backend="xla") on the card
# ---------------------------------------------------------------------------

def coo_operands(lp, dev):
    """solve_lp's COO burst operands of `lp` on `dev`, at the reference's
    cast points: (c, tau, xmax, q, sig, ub), cols, rows."""
    import numpy as np
    from repro_torch.core import solver
    xmax = np.where(np.isfinite(lp.xmax), lp.xmax, 1e12)
    cscale = max(float(np.abs(lp.c).max(initial=0.0)), 1e-12)
    q, tau, sig, cols, rows, ub = solver._pdhg_ops(
        lp.c / cscale, lp.row, lp.col, lp.val, lp.b, lp.h, lp.m, lp.n,
        lp.m_eq, dev)
    return ((solver._f32(lp.c / cscale, dev), tau, solver._f32(xmax, dev), q,
             sig, ub), cols, rows)


def coo_start(lp, seed: int, frozen: bool) -> tuple:
    """(x0, y0, keep_n, keep_m) as numpy: zeros with nothing held, or
    (`frozen`) a random start inside the box with COO_FROZEN of the
    coordinates held."""
    import numpy as np
    if not frozen:
        return (np.zeros(lp.n, np.float32), np.zeros(lp.m, np.float32),
                np.zeros(lp.n, bool), np.zeros(lp.m, bool))
    rng = np.random.default_rng(seed)
    xmax = np.where(np.isfinite(lp.xmax), lp.xmax, 1e12)
    x0 = (rng.random(lp.n) * np.minimum(xmax, 1.0)).astype(np.float32)
    y0 = rng.standard_normal(lp.m).astype(np.float32)
    y0[lp.m_eq:] = np.abs(y0[lp.m_eq:])
    return x0, y0, rng.random(lp.n) < COO_FROZEN, rng.random(lp.m) < COO_FROZEN


def coo_run(operands, start, iters: int, dev, blocks: int = 0):
    """One pdhg_coo_burst from `start` on `dev` (the kernel on the card,
    the plain version on the CPU)."""
    import torch
    from repro_torch.kernels import ops
    vecs, cols, rows = operands
    x0, y0, keep_n, keep_m = (torch.from_numpy(a).to(dev) for a in start)
    kw = {"_blocks": blocks} if blocks else {}
    return ops.pdhg_coo_burst(*vecs, keep_n, keep_m, cols, rows, x0, y0,
                              iters=iters, **kw)


def coo_differs(got, want) -> tuple[int, float]:
    """Entries of (x, y, worst) that differ between two runs, as
    np.array_equal compares them (the sign of a zero aside), and the
    largest |difference|."""
    import numpy as np
    n, err = 0, 0.0
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        n += int(np.count_nonzero(g != w))
        err = max(err, float(np.abs(g.astype(np.float64) - w).max(
            initial=0.0)))
    return n, err


def coo_bound(n: int, m: int, nnz: int) -> tuple[float, str, int, int]:
    """Least time of one COO PDHG iteration on this card, burst_bound's
    way: each operand read once and each output written once (both
    directions' gather index and value an entry, their offsets and
    output lists, the x-side and y-side vectors and masks, x' and y'
    written) against the operations (a multiply and an add an entry each
    way, plus the elementwise updates).  Returns (ms, bound_by, bytes,
    ops)."""
    f4, b1 = 4, 1
    nbytes = (2 * nnz * 2 * f4 + f4 * (n + m + 2) + f4 * (n + m)
              + n * (3 * f4 + f4 + b1 + f4) + m * (2 * f4 + f4 + 2 * b1 + f4))
    nops = 4 * nnz + 7 * n + 4 * m
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = nops / FP32_OPS_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, nops)


def coo_tiers(operands) -> str:
    """The work order of an LP's two directions, for the log."""
    from repro_torch.kernels import pdhg_coo
    _, cols, rows = operands
    out = []
    for name, d in (("columns", cols), ("rows", rows)):
        lengths = d.off.diff().tolist()
        out.append(f"{name}: {d.n_long} long, a warp each or past "
                   f"{pdhg_coo.CHUNK_ENTRIES} entries a block each "
                   f"({d.n_block}; longest {max(lengths, default=0)}), "
                   f"{d.n_out - d.n_long} more in {d.n_chunks} chunks "
                   f"(at most {max(lengths[d.n_long:], default=0)} "
                   f"entries)")
    return "; ".join(out)


def coo_plain_task(task: tuple) -> dict:
    """Phase 33(a)'s host CPU side, in a helper process: the plain
    version's burst of `iters` on `lp` from coo_start(lp, 33, frozen), on
    CPU tensors (torch's CUDA index_add_ adds in no fixed order); with
    `twice`, the negative control that rounds x - tau g and y + sig r
    twice (no fused multiply-add).  Returns (x, y, worst) as numpy and
    the seconds it took."""
    import torch
    from repro_torch.kernels import pdhg_coo
    torch.set_num_threads(1)
    lp, frozen, iters, twice = task
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    with (mock.patch.object(pdhg_coo, "fma32", lambda a, b, c: a * b + c)
          if twice else contextlib.nullcontext()):
        out = coo_run(coo_operands(lp, cpu), coo_start(lp, 33, frozen),
                      iters, cpu)
    return {"out": [t.numpy() for t in out],
            "seconds": time.perf_counter() - t0}


def coo_plain_runs(pool, lps: dict) -> dict:
    """coo_plain_task for every check of coo_kernel_check, submitted to
    `pool` (phase 33's helper processes): {(objective, frozen, iters) or
    "control": future}."""
    runs = {(obj, frozen, iters): pool.submit(coo_plain_task,
                                              (lp, frozen, iters, False))
            for obj, lp in lps.items() for frozen in (False, True)
            for iters in COO_ITERS}
    runs["control"] = pool.submit(coo_plain_task, (lps["energy"], False,
                                                   COO_ITERS[-1], True))
    return runs


def coo_kernel_check(lps: dict, dev, sms: int, plain: dict) -> float:
    """Phase 33(a): pdhg_coo_burst on the card against its plain version
    from the same inputs (`plain`: coo_plain_runs' futures), for each LP
    of `lps` (objective -> LP), at 1 and 500 iterations, cold and from a
    random start with coordinates held: bitwise, and bitwise on a grid
    of one block an SM; a launch on one block more than fit raises; a
    plain version that rounds x - tau g twice (no fused multiply-add)
    must fail the check.  Returns the largest |difference| (0.0)."""
    import torch
    from repro_torch.kernels import build, ops
    info = build.BUILD_INFO["pdhg_coo.cu"]
    say(f"  (a) built pdhg_coo.cu in {info['seconds']:.3f} s (phase 2) -> "
        f"{pathlib.Path(info['library']).name}")
    for line in info["log"].splitlines():
        if ("Compiling entry" in line or "registers" in line
                or "spill" in line):
            say(f"    ptxas: {line.strip()}")
    blocks = ops.coo_max_blocks(dev)
    say(f"    burst grid: {blocks} blocks of {COO_THREADS} fit at once on "
        f"{sms} SMs")
    require(blocks >= sms, f"COO burst grid {blocks}")
    cpu = torch.device("cpu")

    def want(key):
        res = plain[key].result()
        return [torch.from_numpy(a) for a in res["out"]], res["seconds"]

    err = 0.0
    for obj, lp in lps.items():
        on_card = coo_operands(lp, dev)
        say(f"    the flagship's {obj} LP: n={lp.n} m={lp.m} "
            f"nnz={len(lp.val)}; {coo_tiers(coo_operands(lp, cpu))}")
        for frozen in (False, True):
            start = coo_start(lp, 33, frozen)
            for iters in COO_ITERS:
                got = coo_run(on_card, start, iters, dev)
                n1, _ = coo_differs(coo_run(on_card, start, iters, dev, sms),
                                    got)
                ref, plain_s = want((obj, frozen, iters))
                n, e = coo_differs(got, ref)
                what = "random start, 20% held" if frozen else "cold"
                say(f"    {obj:6s} {what:23s} iters={iters:3d}: {n} of "
                    f"{lp.n + 2 * lp.m} entries (x, y, worst) differ from "
                    f"the plain version (max |diff| {e:.3e}; plain "
                    f"{plain_s:.2f} s in a helper process); on {sms} "
                    f"blocks {n1} differ")
                require(n == 0 and n1 == 0,
                        f"pdhg_coo_burst ({obj}, {what}, {iters} "
                        f"iterations) is not bitwise its plain version")
                err = max(err, e)
    lp = lps["energy"]
    on_card = coo_operands(lp, dev)
    before = ops.PDHG_COO_LAUNCHES
    try:
        coo_run(on_card, coo_start(lp, 33, False), 1, dev, blocks + 1)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    say(f"    a launch on {blocks + 1} blocks (one more than fit) raises: "
        f"{refused}")
    require(refused is not None and ops.PDHG_COO_LAUNCHES == before,
            "a COO launch on more blocks than fit did not raise")
    got = coo_run(on_card, coo_start(lp, 33, False), COO_ITERS[-1], dev)
    n, _ = coo_differs(got, want("control")[0])
    say(f"    negative control: the plain version rounding x - tau g and "
        f"y + sig r twice differs in {n} entries after "
        f"{COO_ITERS[-1]} iterations (energy LP)")
    require(n > 0, "the COO check passes a burst without the fused "
                   "multiply-adds")
    return err


def coo_chain(lp) -> tuple[int, int]:
    """The order's chain in entries: the longest sum over any column and
    a row it meets (each iteration waits on a column's chain, then on
    the row chains it feeds, and around again, so no steady state is
    faster than the longest such pair a step), and the longest column
    plus the longest row."""
    import numpy as np
    col_len = np.bincount(lp.col, minlength=lp.n)
    row_len = np.bincount(lp.row, minlength=lp.m)
    pair = int((col_len[lp.col] + row_len[lp.row]).max(initial=0))
    return pair, int(col_len.max(initial=0) + row_len.max(initial=0))


def add_latency_ns(dev) -> dict:
    """The latency of one dependent fp32 add on the card, from the COO
    kernel's add-chain entry: one thread adding COO_ADD_CHAIN[1] - [0]
    more terms, the difference of the two chains' times (median of 3
    each, CUDA events), so the launch drops out; and the SM clock that
    nvidia-smi reads, for the cycles."""
    import torch
    from repro_torch.kernels import ops
    ab = torch.tensor([1.0, -1.0], dtype=torch.float32, device=dev)
    t = [sorted(time_events(lambda: ops.coo_add_chain(n, ab), 1)
                for _ in range(3))[1] for n in COO_ADD_CHAIN]
    ns = (t[1] - t[0]) * 1e6 / (COO_ADD_CHAIN[1] - COO_ADD_CHAIN[0])
    try:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-i", "0"], capture_output=True, text=True,
            timeout=30).stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        mhz = float("nan")
    return {"ns": ns, "mhz": mhz, "cycles": ns * mhz / 1e3,
            "chains_ms": t}


def coo_times(card: str, lps: dict, stack_lp, dev, library_ms: float,
              library8_ms: float) -> dict:
    """Phase 33(d): the COO kernel's ms an iteration at the flagship's
    energy and min-time LPs and at the 8-stack (CUDA events, median of
    3 bursts), its plain version's on the host CPU (it runs on CPU
    tensors only), both bounds (bytes, and the order's chain at the
    measured add latency), and the two torch CSR mat-vecs of phases 6
    and 15 on the same operators (the min-time LP has none)."""
    import torch
    cpu = torch.device("cpu")
    lat = add_latency_ns(dev)
    say(f"    one dependent fp32 add: {lat['ns']:.4f} ns (chains of "
        f"{COO_ADD_CHAIN[0]} and {COO_ADD_CHAIN[1]} adds in one thread: "
        f"{lat['chains_ms'][0]:.6f} and {lat['chains_ms'][1]:.6f} ms), "
        f"{lat['cycles']:.2f} cycles at the {lat['mhz']:.0f} MHz SM clock "
        f"nvidia-smi reads")
    out = {"add_ns": lat["ns"], "add_cycles": lat["cycles"]}
    for label, g, n_k, lib in (("flagship", lps["energy"], 2000, library_ms),
                               ("flagship time", lps["time"], 2000, None),
                               ("8-stack", stack_lp, 1000, library8_ms)):
        operands = coo_operands(g, dev)
        start = coo_start(g, 0, False)
        ms = sorted(time_events(lambda: coo_run(operands, start, n_k, dev),
                                1) / n_k for _ in range(3))[1]
        bound_ms, bound_by, nbytes, nops = coo_bound(g.n, g.m, len(g.val))
        pair, sum_longest = coo_chain(g)
        order_ms = pair * lat["ns"] * 1e-6
        top = max(bound_ms, order_ms)
        lib_s = (f"library {lib:.6f} ms per K.x + K^T.y pair (torch CSR "
                 f"matmul, phases 6/15)" if lib is not None
                 else "no library time")
        say(f"    {label}: kernel {ms:.6f} ms/iter (burst of {n_k}, median "
            f"of 3; {ms / top:.2f}x the larger bound); bytes bound "
            f"{bound_ms:.6f} ms ({bound_by}: {nbytes} B at 3.35 TB/s, "
            f"{nops} fp32 ops at 67 TFLOP/s); order bound {order_ms:.6f} ms "
            f"(a chain of {pair} adds a step, the longest column and a row "
            f"it meets; the longest column plus the longest row "
            f"{sum_longest}); {lib_s} ({card})")
        out[label] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                          order_ms=order_ms, library_ms=lib)
    operands = coo_operands(lps["energy"], cpu)
    start = coo_start(lps["energy"], 0, False)
    n_p = 20
    t0 = time.perf_counter()
    coo_run(operands, start, n_p, cpu)
    out["plain_ms"] = (time.perf_counter() - t0) * 1e3 / n_p
    say(f"    flagship: plain version {out['plain_ms']:.6f} ms/iter on the "
        f"host CPU (burst of {n_p}; it runs on CPU tensors only)")
    return out


def paper_cpu_cell(cell: tuple) -> dict:
    """Phases 4 and 33(b)'s host CPU side, in a helper process: the paper
    cell (topology, objective) solved by solve_fast on the CPU's plain
    path, with the backend named (phase 4: "pallas") or none (phase 33:
    the default, xla).  Returns what the card's solve is held to and the
    seconds it took."""
    import torch
    from repro_torch.core import solver
    torch.set_num_threads(1)
    name, obj, backend = cell
    kw = {} if backend is None else {"backend": backend}
    t0 = time.perf_counter()
    c = solver.solve_fast(problem(name, {}, GOLDEN_PATTERN, 2), obj,
                          device="cpu", **kw)
    return {"lp_x": c.lp_x, "lp_y": c.lp_y, "schedule": c.schedule,
            "iterations": c.iterations, "metrics": metrics_of(c),
            "seconds": time.perf_counter() - t0}


def cpu_pool():
    """CPU_WORKERS spawned processes of this script for phase 4's and
    phase 33's host CPU side, so it runs while the card's checks run.
    The caller shuts the pool down."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(CPU_WORKERS,
                               mp_context=multiprocessing.get_context(
                                   "spawn"))


def paper_cpu_cells(pool, backend: str | None = None) -> dict:
    """The 12 paper cells' CPU solves (paper_cpu_cell) submitted to
    `pool`: each cell's future."""
    return {(name, obj): pool.submit(paper_cpu_cell, (name, obj, backend))
            for name in PAPER_TOPOS for obj in OBJECTIVES}


@contextlib.contextmanager
def default_lowering(label: str, quiet: bool = False):
    """Phase 33's rule for a call that names no backend: over the block
    the COO kernel launched and no kernel of the ELL lowering did.
    Yields a dict that holds the block's COO bursts ("coo") after it."""
    from repro_torch.kernels import ops
    coo = ops.PDHG_COO_LAUNCHES
    ell = {c: getattr(ops, c) for c in ELL_COUNTERS}
    n: dict = {}
    yield n
    n["coo"] = ops.PDHG_COO_LAUNCHES - coo
    grew = {c: getattr(ops, c) - v for c, v in ell.items()
            if getattr(ops, c) != v}
    if not quiet:
        say(f"    {label}: {n['coo']} COO bursts, no ELL launch: "
            f"{not grew}")
    require(n["coo"] > 0 and not grew,
            f"{label}: {n['coo']} COO bursts, ELL launches {grew}; the "
            f"default lowering launches the COO kernel alone")


def coo_paper_cells(dev, paper_fp32: dict, cpu_cells: dict) -> None:
    """Phase 33(b): solve_fast with no backend named (the default, xla)
    on the six paper topologies x {energy, time}: the COO kernel
    launched and the ELL burst not (default_lowering), certified, two
    card runs bitwise equal, bitwise the host CPU's plain path (lp_x,
    lp_y, schedule, iterations, metrics; `cpu_cells`: paper_cpu_cells'
    futures), and within METRIC_RTOL of the golden pins where there is
    one, else of phase 4's pallas solve."""
    import numpy as np
    from repro_torch.core import solver, verify
    golden = json.loads(GOLDEN.read_text())
    for name in PAPER_TOPOS:
        p = problem(name, {}, GOLDEN_PATTERN, 2)
        for obj in OBJECTIVES:
            with default_lowering(f"{name}/{obj}", quiet=True) as n:
                t0 = time.perf_counter()
                r = solver.solve_fast(p, obj, device=dev)
                wall = time.perf_counter() - t0
                again = solver.solve_fast(p, obj, device=dev)
            verify.check_schedule(p, r.schedule).assert_ok(
                f"{name}/{obj} xla on the card")
            c = cpu_cells[name, obj].result()
            cpu_s = c["seconds"]

            def same(a, b):
                return (np.array_equal(a.lp_x, b.lp_x)
                        and np.array_equal(a.lp_y, b.lp_y)
                        and np.array_equal(a.schedule, b.schedule)
                        and a.iterations == b.iterations
                        and metrics_of(a) == metrics_of(b))

            def same_cpu(a, b):
                return (np.array_equal(a.lp_x, b["lp_x"])
                        and np.array_equal(a.lp_y, b["lp_y"])
                        and np.array_equal(a.schedule, b["schedule"])
                        and a.iterations == b["iterations"]
                        and metrics_of(a) == b["metrics"])

            got = metrics_of(r)
            if name in GOLDEN_TOPOS:
                want = golden[f"{name}/min-{obj}/seed0"]
                want, pin = {k: want[k] for k in got}, "golden"
            else:
                want, pin = paper_fp32[name, obj], "phase 4 (pallas)"
            near = close(got, want, METRIC_RTOL)
            say(f"    {name:10s} {obj:6s} E={got['energy_j']:.6f} J "
                f"M={got['completion_s']:.6f} s iters={r.iterations} "
                f"wall={wall:.3f} s (cpu {cpu_s:.3f} s, a helper process) "
                f"COO bursts {n['coo']}, ELL 0; "
                f"cert=ok; twice bitwise {same(r, again)}; bitwise the cpu "
                f"{same_cpu(r, c)}; within {METRIC_RTOL:g} of {pin} {near}")
            require(same(r, again), f"{name}/{obj} xla: two card runs differ")
            require(same_cpu(r, c), f"{name}/{obj} xla: card and cpu differ")
            require(near, f"{name}/{obj} xla: {got} vs {pin} {want}")


def coo_batch_and_sweep(dev, probs8, lps8) -> None:
    """Phase 33(c), every call naming no backend (the default, xla; the
    COO kernel launched and the ELL burst not): the 8-stack through
    solve_fast_batch, each member certified and its LP solve bitwise its
    solo solve (a batch of one, the same chunk schedule); then the
    sweep CLI without --backend over phase 14's spine-leaf energy/skew
    rows, the backend column xla, every row within SWEEP_RTOL of the
    committed results (the reference's xla run), the
    summation-order-sensitive seed 5 included."""
    import numpy as np
    from repro_torch.core import solver, verify
    from repro_torch.sweep import __main__ as sweep_main
    with default_lowering("the 8-stack"):
        t0 = time.perf_counter()
        batch = solver.solve_fast_batch(probs8, "energy", device=dev)
        wall = time.perf_counter() - t0
    same = []
    with default_lowering("its 8 solo solves"):
        for seed, p, lp, b in zip(BATCH_SEEDS, probs8, lps8, batch):
            verify.check_schedule(p, b.schedule).assert_ok(
                f"xla batch {seed}")
            s = solver.solve_lp_batch([lp], chunk=500, device=dev)[0]
            same.append(np.array_equal(s.x, b.lp_x)
                        and np.array_equal(s.y, b.lp_y)
                        and s.iterations == b.iterations)
    say(f"    8-stack (fat-tree k=16, seeds {BATCH_SEEDS[0]}-"
        f"{BATCH_SEEDS[-1]}): wall {wall:.3f} s, iterations "
        f"{[b.iterations for b in batch]}, every schedule certified; each "
        f"member bitwise its solo solve: {sum(same)} of {len(same)}")
    require(all(same), "an xla batch member differs from its solo solve")
    with tempfile.TemporaryDirectory() as tmp, \
            default_lowering("the sweep"):
        t0 = time.perf_counter()
        rc = sweep_main.main(COO_SWEEP_ARGS + ["--device", str(dev),
                                               "--out", tmp])
        sweep_wall = time.perf_counter() - t0
        with open(pathlib.Path(tmp) / "results.csv", newline="") as fh:
            backends = {r["backend"] for r in csv.DictReader(fh)}
        rows = sweep_rows(pathlib.Path(tmp) / "results.csv")
    ref = sweep_rows(SWEEP_RESULTS)
    worst = max(max(rel_diff(float(row[c]), float(ref[key][c]))
                    for c in ("energy_j", "completion_s"))
                for key, row in rows.items())
    say(f"    sweep {' '.join(COO_SWEEP_ARGS)}: exit {rc}, {len(rows)} rows "
        f"in {sweep_wall:.1f} s, backend column {sorted(backends)}; worst "
        f"relative difference from results/sweep/results.csv {worst:.3e}")
    for key in SWEEP_ORDER_SENSITIVE:
        say(f"    {key}: E={float(rows[key]['energy_j']):.6f} J against the "
            f"committed {float(ref[key]['energy_j']):.6f} J")
    require(rc == 0 and len(rows) == len(BATCH_SEEDS)
            and backends == {"xla"}, f"xla sweep: exit {rc}, {len(rows)} "
                                     f"rows, backend {backends}")
    require(all(r["feasible"] == "True" for r in rows.values()),
            "xla sweep: an infeasible row")
    require(worst <= SWEEP_RTOL, f"xla sweep rows {worst:.3e} off the "
                                 f"committed results")


def coo_online(dev) -> None:
    """Phase 33(e): run_online with no backend named (the default, xla;
    the COO kernel launched and the ELL burst not), warm, on phase 20's
    heavy spine-leaf trace (tests/test_arrivals.py's), on the card and
    on the host CPU's plain path: bitwise equal in every epoch."""
    from repro_torch.core import arrivals, topology, traffic
    sl = topology.build("spine-leaf")
    heavy = arrivals.generate_trace(
        sl, traffic.pattern("uniform", **HEAVY),
        arrivals.ArrivalSpec(family="poisson", n_coflows=4,
                             mean_interarrival_s=2.0), seed=0)
    runs = {}
    for d in (dev, "cpu"):
        with (default_lowering("the heavy trace on the card") if d == dev
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            runs[d] = arrivals.run_online(sl, heavy, "energy", **ONLINE_KW,
                                          device=d)
            runs[d, "s"] = time.perf_counter() - t0
    card = runs[dev]
    report_online("spine-leaf heavy trace, the default lowering, card",
                  card, heavy, runs[dev, "s"], 0.0)
    same = online_bitwise(card, runs["cpu"])
    say(f"    the CPU's plain path ({runs['cpu', 's']:.1f} s): bitwise "
        f"the card in every epoch: {same}"
        + ("" if same else f" ({online_differs(card, runs['cpu'])[:4]})"))
    require(card.n_epochs > 1 and any(e.warm for e in card.epochs[1:]),
            "the heavy trace did not roll warm under xla")
    require(same, "run_online (the default, xla): the card differs from "
                  "the CPU")


def coo_flagship(dev, p_full, ell: dict) -> None:
    """Phase 33(f): the flagship (fat-tree k=16, 20 x 12 shuffle) through
    solve_fast with no backend named, each objective twice: the COO
    kernel launched and the ELL burst not, certified, the two runs
    bitwise equal, and the metrics within METRIC_RTOL of phase 5's ELL
    solve of the same problem (`ell`: objective -> metrics_of)."""
    import numpy as np
    from repro_torch.core import solver, verify
    for obj in OBJECTIVES:
        runs, walls = [], []
        with default_lowering(f"flagship {obj}", quiet=True) as n:
            for _ in range(2):
                t0 = time.perf_counter()
                runs.append(solver.solve_fast(p_full, obj, device=dev))
                walls.append(time.perf_counter() - t0)
        r, again = runs
        t0 = time.perf_counter()
        verify.check_schedule(p_full, r.schedule).assert_ok(
            f"fat-tree-k16/{obj}, the default lowering")
        cert_s = time.perf_counter() - t0
        same = (np.array_equal(r.lp_x, again.lp_x)
                and np.array_equal(r.lp_y, again.lp_y)
                and np.array_equal(r.schedule, again.schedule)
                and r.iterations == again.iterations)
        got = metrics_of(r)
        off = max(rel_diff(got[k], ell[obj][k]) for k in got)
        say(f"    flagship {obj:6s}: walls {walls[0]:.3f} ; {walls[1]:.3f} s"
            f" iters={r.iterations} restarts={restarts(r.iterations, 4000)}"
            f" primal={r.lp_primal_residual:.3e} E={got['energy_j']:.6f} J "
            f"M={got['completion_s']:.6f} s; COO bursts {n['coo']}, ELL 0; "
            f"cert=ok ({cert_s:.3f} s); twice bitwise {same}; metrics "
            f"{off:.3e} from phase 5's ELL solve")
        require(same, f"fat-tree-k16/{obj}, the default lowering: two "
                      f"runs differ")
        require(close(got, ell[obj], METRIC_RTOL),
                f"fat-tree-k16/{obj}, the default lowering: {got} vs "
                f"phase 5's {ell[obj]}")


def coo_phase(card: str, dev, sms: int, p_full, lp_full, probs8, lps8,
              paper_fp32: dict, full_fp32: dict, library_ms: float,
              library8_ms: float) -> dict:
    """Phase 33: the COO lowering, the port's default, on the card.  (a)
    the kernel against its plain version; (b)-(c), (e) and (f) the main
    path as a caller runs it, naming no backend (each block holds that
    the COO kernel launched and the ELL lowering's did not), its launch
    counts reset just before (b) and read after (f); (d) times.
    Returns the kernels line's numbers."""
    from repro_torch.core import solver
    from repro_torch.kernels import ops
    say(f"[33] the default COO lowering (backend='xla', as in the "
        f"reference) on the card ({card})")
    lps = {"energy": lp_full,
           "time": solver.build_routing_lp(p_full, "time")[0]}
    with cpu_pool() as pool:
        plain = coo_plain_runs(pool, lps)
        cpu_cells = paper_cpu_cells(pool)
        err = coo_kernel_check(lps, dev, sms, plain)
        say("  (b) solve_fast, no backend named: six paper topologies x "
            "{energy, time}")
        ops.PDHG_COO_LAUNCHES = 0
        ops.PDHG_COO_RESIDUAL_LAUNCHES = 0
        coo_paper_cells(dev, paper_fp32, cpu_cells)
    say("  (c) the batch and the sweep, no backend named")
    coo_batch_and_sweep(dev, probs8, lps8)
    say("  (e) run_online on the heavy trace, no backend named")
    coo_online(dev)
    say("  (f) solve_fast on the flagship, no backend named")
    coo_flagship(dev, p_full, full_fp32)
    launches = ops.PDHG_COO_LAUNCHES
    residuals = ops.PDHG_COO_RESIDUAL_LAUNCHES
    say(f"    pdhg_coo_burst launches on (b), (c), (e) and (f): {launches} "
        f"bursts (one cooperative launch each), residual entry "
        f"{residuals}")
    require(launches > 0 and residuals == launches,
            "phase 33 did not go through the COO kernel")
    say("  (d) times")
    times = coo_times(card, lps, solver.block_stack(lps8).lp, dev,
                      library_ms, library8_ms)
    flag = times["flagship"]
    return {"name": "pdhg_coo_burst", "route": "cuda", "source": COO_SOURCE,
            "replaces": COO_REPLACES, "launches": launches,
            "max_abs_err": err, "ms": flag["ms"],
            "plain_ms": times["plain_ms"], "bound_ms": flag["bound_ms"],
            "bound_by": flag["bound_by"], "library_ms": flag["library_ms"],
            "order_bound_ms": flag["order_ms"],
            "ms_time_lp": times["flagship time"]["ms"],
            "order_bound_ms_time_lp": times["flagship time"]["order_ms"],
            "ms_8stack": times["8-stack"]["ms"],
            "bound_ms_8stack": times["8-stack"]["bound_ms"],
            "add_ns": times["add_ns"]}


HELPERS: dict = {}            # start_helpers' pool and directory


def start_helpers() -> dict:
    """Phase 32(d)'s dry-run cells and phase 34's host CPU runs of the
    examples, each set one job of a pool of two spawned processes of
    this script (one thread each, niced: the phases before them run host
    work of their own), started at the top so that their host time
    overlaps the card's phases.  train_lm's weights are drawn here, once,
    as step 0 of the host's checkpoint and of the card's.  Returns the
    jobs' futures, their deadline and their directory."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-helpers-"))
    HELPERS["tmp"] = tmp
    train_lm_start([tmp / "train_lm_cpu", tmp / "train_lm_cuda"])
    pool = ProcessPoolExecutor(2, mp_context=multiprocessing.get_context(
        "spawn"))
    HELPERS["pool"] = pool
    return {"tmp": tmp, "deadline": time.monotonic() + HELPER_TIMEOUT_S,
            "dryrun": pool.submit(dryrun_cells, DRYRUN_CELLS),
            "examples": pool.submit(example_cpu_runs, EXAMPLES, tmp)}


def helper_result(helpers: dict, job: str):
    """A helper job's result, waited for until the helpers' deadline; its
    exception, or TimeoutError past the deadline, is raised."""
    return helpers[job].result(
        timeout=max(helpers["deadline"] - time.monotonic(), 1.0))


def stop_helpers() -> None:
    """Kill the helper processes still running (ProcessPoolExecutor has
    no public call for it before Python 3.14) and remove their
    directory."""
    pool = HELPERS.pop("pool", None)
    if pool is not None:
        for proc in list(pool._processes.values()):
            proc.kill()
        pool.shutdown(wait=True, cancel_futures=True)
    tmp = HELPERS.pop("tmp", None)
    if tmp is not None:
        shutil.rmtree(tmp, ignore_errors=True)


def train_lm_start(dirs: list[pathlib.Path]) -> None:
    """train_lm's weights at EXAMPLE_SIZES, drawn once on the host (the
    launcher's seed 0), written as step 0 of a checkpoint in each of
    `dirs` for a run to resume from."""
    import torch
    from repro_torch import configs
    from repro_torch.ft import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.train import optimizer as ropt
    kw = EXAMPLE_SIZES["train_lm"]
    cfg = train.scale_config(configs.get("phi4-mini-3.8b", smoke=True),
                             kw["d_model"], kw["n_layers"])
    model = transformer.Transformer(
        cfg, generator=torch.Generator().manual_seed(0),
        device=torch.device("cpu"))
    tree = {"params": model.state_dict(),
            "opt": ropt.adamw_init(dict(model.named_parameters()))}
    for d in dirs:
        CheckpointManager(d).save(0, tree)


def load_example(name: str):
    """examples_torch/<name>.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, device: str, backend: str | None,
                tmp: pathlib.Path | None = None):
    """One example's run at phase 34's sizes, printing as it runs
    (train_lm resumes from its step 0 under `tmp`: train_lm_start)."""
    mod = load_example(name)
    kw = dict(EXAMPLE_SIZES[name])
    if backend is not None:
        return mod.run(device, backend, **kw)
    if name == "train_lm":
        kw.update(ckpt_dir=tmp / f"train_lm_{device}", resume=True)
    return mod.run(device, **kw)


def example_numbers(name: str, out):
    """The numbers an example's run printed (its output less "results")."""
    if isinstance(out, dict):
        return {k: (v.tolist() if hasattr(v, "tolist") else v)
                for k, v in out.items() if k != "results"}
    return list(out)


def example_cpu_runs(names, tmp: pathlib.Path) -> dict:
    """A helper's job: each example's runs of phase 34 on the host CPU but
    serve_batch's (greedy_tokens_hold decodes its weights), under each
    of its lowerings, one after another, by name."""
    import torch
    os.nice(10)
    torch.set_num_threads(1)
    return {name: {b: example_numbers(name, run_example(name, "cpu", b, tmp))
                   for b in EXAMPLE_BACKENDS.get(name, (None,))}
            for name in names if name != "serve_batch"}


def numbers_differ(got, want, rtol: float, where: str = "") -> list[str]:
    """Where two runs' printed numbers differ: floats by more than rtol of
    the larger and EXAMPLE_ATOL (rtol 0: bitwise), anything else
    unequal."""
    import numpy as np
    if isinstance(want, dict):
        if set(got) != set(want):
            return [f"{where}: keys differ"]
        return [m for k in want
                for m in numbers_differ(got[k], want[k], rtol,
                                        f"{where}/{k}")]
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return [f"{where}: {len(got)} != {len(want)} entries"]
        return [m for i, (a, b) in enumerate(zip(got, want))
                for m in numbers_differ(a, b, rtol, f"{where}[{i}]")]
    if isinstance(want, (float, np.floating)):
        a, b = float(got), float(want)
        if a == b or (math.isnan(a) and math.isnan(b)) or (
                rtol and abs(a - b) <= max(rtol * max(abs(a), abs(b)),
                                           EXAMPLE_ATOL)):
            return []
        return [f"{where}: {a!r} != {b!r}"]
    return [] if got == want else [f"{where}: {got!r} != {want!r}"]


def certify_example(name: str, out) -> int:
    """Certify every schedule an example's run returned; the number
    certified."""
    from repro_torch.core import verify
    import numpy as np
    if name in ("serve_batch", "train_lm"):
        return 0
    n = 0
    for r in out["results"]:
        if name == "online_arrivals":
            require(all(e.feasible for e in r.epochs),
                    f"{name}: an epoch is not feasible")
            n += len(r.epochs)
        elif name == "coflow_schedule":
            sent = r.share.sum(axis=(1, 2))
            require(np.allclose(sent, 1.0, atol=1e-6) and r.share.min()
                    >= -1e-9, f"{name}: a bucket's shares sum to "
                              f"{sent.min()}..{sent.max()}")
            n += 1
        else:
            p, res = r
            verify.check_schedule(p, res.schedule).assert_ok(name)
            n += 1
    return n


def greedy_tokens_hold(arch: str, card_tokens, dev) -> str:
    """serve_batch's tokens on the card against the host CPU's greedy
    decode of the same weights (drawn on the card by serve.build, copied
    to the host): equal at every step up to a row's first step whose
    CPU greedy choice is not exact (its logit leads the next by
    GREEDY_EXACT_PLACES bf16 places or fewer); the rows' report."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.runtime import steps
    kw = {**load_example("serve_batch").run.__kwdefaults__,
          **EXAMPLE_SIZES["serve_batch"]}
    B, P, G = kw["batch"], kw["prompt_len"], kw["gen"]
    cfg = configs.get(arch, smoke=True)
    drawn, inputs = serve.build(cfg, B, P, 0, dev)
    cpu = torch.device("cpu")
    model = transformer.Transformer(cfg, generator=torch.Generator(),
                                    device=cpu)
    model.load_state_dict({k: v.cpu() for k, v in
                           drawn.state_dict().items()})
    inputs = {k: v.cpu() for k, v in inputs.items()}
    # serve.generate's greedy loop, keeping each step's two largest logits
    pos0 = P + serve.prefix_len(cfg)
    prefill = steps.make_prefill_step(cfg, impl="kernel", max_len=pos0 + G)
    decode = steps.make_decode_step(cfg, impl="kernel")
    logits, caches = prefill(model, inputs)
    toks, tops = [], []
    for i in range(G):
        if i:
            logits, caches = decode(model, caches, toks[-1][:, None],
                                    pos0 + i - 1, None)
        toks.append(torch.argmax(logits[:, -1], dim=-1))
        tops.append(logits[:, -1].float().topk(2, dim=-1).values)
    cpu_tokens = torch.stack(toks, dim=1).numpy()
    top2 = torch.stack(tops, dim=1)
    rows = []
    for b in range(B):
        for j in range(G):
            lead = float(top2[b, j, 0] - top2[b, j, 1])
            place = 2.0 ** (math.floor(math.log2(max(
                abs(float(top2[b, j, 0])), 1e-30))) - 7)
            if card_tokens[b, j] != cpu_tokens[b, j]:
                require(lead <= GREEDY_EXACT_PLACES * place,
                        f"serve_batch {arch} row {b} step {j}: the card "
                        f"chose {card_tokens[b, j]}, the CPU "
                        f"{cpu_tokens[b, j]}, whose logit leads by "
                        f"{lead:.4g} ({lead / place:.1f} bf16 places)")
                rows.append(f"row {b} equal to step {j}, then a near tie "
                            f"({lead / place:.1f} places)")
                break
        else:
            rows.append(f"row {b} equal at all {G} steps")
    return "; ".join(rows)


def compare_examples(card_runs: dict, helpers: dict, dev) -> None:
    """Phase 34's checks of the card's runs against the host CPU's (the
    examples' helper): the printed numbers within METRIC_RTOL under
    "pallas" (where they differ more, phase 20's order rule: the CPU run
    summing each row in the kernel's order must give the card's numbers
    bitwise), bitwise under "xla" (coflow_schedule's plans among them:
    the default lowering); serve_batch's tokens by
    greedy_tokens_hold; train_lm's losses, one a step from the same
    weights, within TRAIN_LOSS_TOL."""
    import numpy as np
    for (arch, toks) in card_runs["serve_batch", None].items():
        say(f"    serve_batch {arch}: {greedy_tokens_hold(arch, toks, dev)}")
    cpu = helper_result(helpers, "examples")
    losses, want = card_runs["train_lm", None], cpu["train_lm"][None]
    off = [abs(a - b) for a, b in zip(losses, want)]
    say(f"    train_lm: losses {losses} on the card, {want} on the host; "
        f"apart by {max(off):.3g} at most (within {TRAIN_LOSS_TOL:g} "
        f"required)")
    require(len(losses) == len(want) == EXAMPLE_SIZES["train_lm"]["steps"]
            and np.isfinite(losses).all()
            and max(off) <= TRAIN_LOSS_TOL,
            f"train_lm's losses {losses} against the host's {want}")
    for name in EXAMPLES:
        if name in ("serve_batch", "train_lm"):
            continue
        for backend, want in cpu[name].items():
            got = example_numbers(name, card_runs[name, backend])
            # coflow_schedule names no backend: its plans solve in the
            # default lowering, xla
            if backend == "xla" or name == "coflow_schedule":
                off = numbers_differ(got, want, 0.0)
                rule = "bitwise the CPU's"
            else:
                off = numbers_differ(got, want, METRIC_RTOL)
                rule = f"within {METRIC_RTOL:g} of the CPU's"
                if off:
                    say(f"    {name}/{backend}: off the CPU's ("
                        f"{'; '.join(off[:4])}); the CPU run in the "
                        f"kernel's summation order")
                    with in_kernel_order():
                        ko = example_numbers(name, run_example(
                            name, "cpu", backend))
                    off = numbers_differ(got, ko, 0.0)
                    rule = "bitwise the CPU's in the kernel's order"
            say(f"    {name}{'/' + backend if backend else ''}: "
                f"{rule}: {not off}")
            require(not off, f"{name} ({backend}) off the CPU: {off[:10]}")


def examples_phase(card: str, dev, helpers: dict) -> dict:
    """Phase 34: each example's run at EXAMPLE_SIZES on the card, under
    each lowering it takes, every schedule certified, held to the host
    CPU by compare_examples; the launch counts of the four kernels reset
    before the runs and read after."""
    from repro_torch.kernels import ops
    say(f"[34] the seven examples (examples_torch/) on the card ({card})")
    t_phase = time.perf_counter()
    ops.PDHG_BURST_LAUNCHES = 0
    ops.PDHG_COO_LAUNCHES = 0
    ops.FLASH_ATTENTION_LAUNCHES = 0
    ops.RGLRU_SCAN_LAUNCHES = 0
    card_runs, walls, certs = {}, {}, 0
    for name in EXAMPLES:
        for backend in EXAMPLE_BACKENDS.get(name, (None,)):
            t0 = time.perf_counter()
            out = run_example(name, "cuda", backend, helpers["tmp"])
            walls[name, backend] = time.perf_counter() - t0
            certs += certify_example(name, out)
            card_runs[name, backend] = out
    launches = {"pdhg_burst": ops.PDHG_BURST_LAUNCHES,
                "pdhg_coo_burst": ops.PDHG_COO_LAUNCHES,
                "flash_attention": ops.FLASH_ATTENTION_LAUNCHES,
                "rglru_scan": ops.RGLRU_SCAN_LAUNCHES}
    card_s = time.perf_counter() - t_phase
    say(f"  the card's runs: {card_s:.1f} s ("
        + ", ".join(f"{n}{'/' + b if b else ''} {w:.1f}"
                    for (n, b), w in walls.items())
        + f"); {certs} schedules certified; launches {launches}")
    require(all(v > 0 for v in launches.values()),
            f"phase 34 did not launch every kernel: {launches}")
    compare_examples(card_runs, helpers, dev)
    wall = time.perf_counter() - t_phase
    say(f"    phase 34: {wall:.1f} s ({card_s:.1f} s of the card's runs)")
    return {"launches": launches, "wall": wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep-out", default="",
                    help="directory for phase 14's results.csv and "
                         "results.md (default: a new temporary directory)")
    # phase 24's helper processes (see cpu_placement_rows)
    ap.add_argument("--placement-cpu", default="", help=argparse.SUPPRESS)
    # phase 30's ranks (see run_shard_ranks)
    ap.add_argument("--shard-rank", type=int, default=-1,
                    help=argparse.SUPPRESS)
    ap.add_argument("--shard-world", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--shard-dir", default="", help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if opts.placement_cpu:
        return placement_cpu_cell(opts.placement_cpu)
    if opts.shard_rank >= 0:
        return shard_rank_main(opts.shard_rank, opts.shard_world,
                               opts.shard_dir)
    sweep_out = opts.sweep_out
    # phase 28's bitwise repeatable training needs cuBLAS's workspace
    # fixed before the process's first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    helpers = start_helpers()
    # -- phase 1: card -----------------------------------------------------
    card = card_line()
    say(f"[1] card: {card}")
    say(f"    torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices "
        f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products summed in fp32 and rounded once (models/common.py's
    # matmul), as the serve CLI sets it: no split-K reduction in bf16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    say(f"    allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; bf16 reduced-precision "
        f"reduction "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    dev = torch.device("cuda", 0)

    # -- phase 2: build (the four kernels, one nvcc each, started together)
    with ThreadPoolExecutor(len(build.SOURCES)) as pool:
        list(pool.map(build.load, build.SOURCES))
    info = build.BUILD_INFO["pdhg_burst.cu"]
    say(f"[2] built pdhg_burst.cu in {info['seconds']:.3f} s -> "
        f"{pathlib.Path(info['library']).name}")
    for line in info["log"].splitlines():
        if "Compiling entry" in line:
            # the fused kernel and the split step, each in its two
            # templates: fp32 and bf16-storage iterates
            kind = "bf16" if "bfloat16" in line else "fp32"
            name = re.search(r"(pdhg_burst_kernel|pdhg_split_step)", line)
            say(f"    ptxas [{name.group(1) if name else '?'} {kind}]: "
                f"{line.strip()}")
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
    # the same solves on the host CPU, in helper processes meanwhile
    with cpu_pool() as pool:
        cpu_cells = paper_cpu_cells(pool, "pallas")
        for name in PAPER_TOPOS:
            p = problem(name, {}, GOLDEN_PATTERN, 2)
            for obj in OBJECTIVES:
                before = ops.PDHG_BURST_LAUNCHES
                t0 = time.perf_counter()
                r = solver.solve_fast(p, obj, backend="pallas",
                                      device="cuda")
                wall = time.perf_counter() - t0
                paper_launches += ops.PDHG_BURST_LAUNCHES - before
                cert = verify.check_schedule(p, r.schedule)
                cert.assert_ok(f"{name}/{obj} on the card")
                got = metrics_of(r)
                paper_fp32[name, obj] = got
                cpu = cpu_cells[name, obj].result()["metrics"]
                require(close(got, cpu, METRIC_RTOL),
                        f"{name}/{obj}: card {got} vs cpu {cpu}")
                pin = ""
                if name in GOLDEN_TOPOS:
                    want = golden[f"{name}/min-{obj}/seed0"]
                    require(close(got, {k: want[k] for k in got},
                                  METRIC_RTOL),
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
    full_lp, full_lp_s = {}, {}   # for phase 23
    for obj in OBJECTIVES:
        runs = []
        for rep in range(2):
            t0 = time.perf_counter()
            r = solver.solve_fast(p_full, obj, backend="pallas", device="cuda")
            wall = time.perf_counter() - t0
            full_lp[obj], full_lp_s[obj] = r, wall
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
    templates = ptxas_templates(fa_info["log"], setmaxnreg_split())
    for line in templates:
        say(f"    ptxas: {line}")
    n_bf16, n_fp32 = attention_template_counts()
    require(len(templates) == n_bf16 + n_fp32 or not fa_info["log"],
            f"expected {n_bf16 + n_fp32} attention templates ({n_bf16} "
            f"bf16, {n_fp32} fp32) in the ptxas log, found "
            f"{len(templates)}")
    wgmma_lines = [t for t in templates if "wgmma" in t]
    require(all("spill stores 0 B" in t for t in wgmma_lines),
            "the bf16 attention kernel spills registers")
    simt_lines = [t for t in templates if "simt" in t]
    require(all("spill stores 0 B" in t and "loads 0 B" in t
                for t in simt_lines),
            "the fp32 attention kernel spills registers")
    tc_words = simt_tensor_core_words()
    require(not tc_words, f"the fp32 attention entry's source names "
                          f"{tc_words}: its products must stay on the FMA "
                          f"units")
    say(f"    fp32 entry: {len(simt_lines)} templates without spills, no "
        f"mma, wgmma or TF32 in its source")
    require("C7512" not in fa_info["log"] and "C7508" not in fa_info["log"],
            "ptxas serialized the bf16 attention kernel's wgmma or ignored "
            "its setmaxnreg")

    # -- phase 8: attention kernel vs plain version ------------------------
    say("[8] attention kernel vs plain version on the card")
    bad_layout = attention_layout_probe(dev)
    require(not bad_layout, f"layout probe: the bf16 kernel's "
                            f"{', '.join(bad_layout)} laid out wrong")
    fa_errs = []
    fa32_errs = []              # the fp32 SIMT entry's (PERF.md row 2f)
    fa32_launches = 0
    for seed, (name, B, S, H, Hkv, hd, window, cap, causal) in enumerate(
            FA_CASES):
        for dt in FA_DTYPES:
            q, k, v = fa_inputs(seed, B, S, H, Hkv, hd, getattr(torch, dt),
                                dev)
            before = ops.FLASH_ATTENTION_LAUNCHES
            fa_errs.append(compare_attention(
                f"{name} S={S} H={H}/{Hkv} hd={hd} w={window} cap={cap:g}"
                f"{'' if causal else ' non-causal'}",
                q, k, v, window, cap, causal))
            if dt == "float32":
                fa32_launches += ops.FLASH_ATTENTION_LAUNCHES - before
                fa32_errs.append(fa_errs[-1])
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
    require(fa32_launches == 2 * len(FA_CASES),
            f"phase 8's fp32 cases launched the fp32 entry "
            f"{fa32_launches} times, expected {2 * len(FA_CASES)}")
    n = attention_misaligned(dev)
    say(f"    flash_attention launches on the misaligned case: {n}")
    require(n == 2 * len(FA_DTYPES), f"the misaligned case launched the "
                                     f"kernel {n} times, expected "
                                     f"{2 * len(FA_DTYPES)}")

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
    model, inputs = serve.build(cfg, 4, 2048, 0, dev)
    toks = inputs["tokens"]
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
    compare_sublayers("phi4 prefill", model, inputs)

    say("    h2o-danube-3-4b at full width, 4 layers (window 4096, hd 120), "
        "batch 1, prompt 6144, 8 tokens")
    dcfg = dataclasses.replace(configs.get("h2o-danube-3-4b"), n_layers=4)
    dmodel, dinputs = serve.build(dcfg, 1, 6144, 0, dev)
    dtoks = dinputs["tokens"]
    ops.FLASH_ATTENTION_LAUNCHES = 0
    g = serve.generate(dmodel, dinputs, 8, impl="kernel")
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
    compare_sublayers("danube prefill", dmodel, dinputs)
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        ops.flash_attention(q, k, v)
    fa_host_us = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
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
        f"SDPA's time")
    say(f"    host time        {fa_host_us:.3f} us a call (the wrapper, three "
        f"tensor-map encodes and the launch, 20 calls queued behind the "
        f"card)")
    fa32_entry = fa32_times(card, dev, fa32_launches, max(fa32_errs))
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(model, {"tokens": toks})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prefill_wall = sorted(walls)[1]
    g = serve.generate(model, inputs, 32, impl="kernel")
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
    del model, inputs, toks, g, tok   # phi4's weights and caches
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
            r = solver.solve_fast(p, obj, precision="bf16",
                                  backend="pallas", device="cuda")
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
    r = solver.solve_fast(p_full, "energy", precision="bf16",
                          backend="pallas", device="cuda")
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
        batch = solver.solve_fast_batch(probs8, "energy",
                                        backend="pallas", device="cuda")
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
        s = solver.solve_fast(p, "energy", backend="pallas", device="cuda")
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
    again = solver.solve_fast_batch(probs8, "energy",
                                    backend="pallas", device="cuda")
    say(f"    (e) repeat wall {time.perf_counter() - t0:.3f} s")
    for seed, a, b in zip(BATCH_SEEDS, batch, again):
        require(np.array_equal(a.lp_x, b.lp_x) and np.array_equal(a.lp_y, b.lp_y)
                and np.array_equal(a.schedule, b.schedule)
                and a.iterations == b.iterations,
                f"batch seed {seed}: two runs differ")
    say("    (e) two batch runs bitwise identical (lp_x, lp_y, schedule)")
    fixed = solver.solve_lp_batch(lps8[:4], adaptive=False,
                                  backend="pallas", device="cuda")
    for seed, lp, b in zip(BATCH_SEEDS, lps8[:4], fixed):
        single = solver.solve_lp(lp, backend="pallas", device="cuda")
        err = float(np.abs(b.x - single.x).max())
        bitwise = np.array_equal(b.x, single.x)
        say(f"    (b) seed {seed} adaptive=False: iters {b.iterations} "
            f"(solo {single.iterations}), max|batch-solo| x {err:.3e}, "
            f"bitwise {bitwise}")
        require(err <= BATCH_X_ATOL and b.iterations == single.iterations,
                f"adaptive=False seed {seed}: x differs by {err:.3e}")
    dup = solver.solve_lp_batch([lp_full] * 8, backend="pallas", device="cuda")
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
                                                    backend="pallas",
                                                    device="cpu"))
    cpu_worst = 0.0
    for rec in cpu_recs:
        row = rows[rec.topo, rec.objective, rec.pattern, rec.seed]
        cpu_worst = max(cpu_worst, rel_diff(float(row["energy_j"]),
                                            rec.energy_j),
                        rel_diff(float(row["completion_s"]), rec.completion_s))
    say(f"    the same spec on this machine's CPU ({len(cpu_recs)} rows of "
        f"spine-leaf and pon3, uniform, seed 0, {time.perf_counter() - t0:.1f}"
        f" s): worst relative difference {cpu_worst:.3e}")
    require(cpu_worst <= SWEEP_RTOL, "sweep: card and CPU rows differ")
    t0 = time.perf_counter()
    with in_kernel_order():
        ko_recs, _ = runner.run_sweep(runner.SweepSpec(**SWEEP_CPU_CELLS,
                                                       backend="pallas",
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
    again, _ = runner.run_sweep(runner.SweepSpec(backend="pallas", **cell))
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
        probs8, "energy", backend="pallas", device="cuda"))
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
            a, b = misaligned(a), misaligned(b)
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
    rmodel, rinputs = serve.build(rcfg, 4, 4096, 0, dev)
    rtoks = rinputs["tokens"]
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
    compare_sublayers("recurrentgemma prefill", rmodel, rinputs)

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
        f"{rfa_ms / rfa_lib_ms:.3f}x SDPA's time")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rprefill(rmodel, {"tokens": rtoks})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    rprefill_wall = sorted(walls)[1]
    g = serve.generate(rmodel, rinputs, 32, impl="kernel")
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
    del rmodel, rinputs, rtoks, rprefill, rdecode, g, tok
    torch.cuda.empty_cache()

    # -- phase 19: failures and warm re-solves at full size ----------------
    say(f"[19] failures: phase 13's 8-stack (fat-tree k=16, seeds "
        f"{BATCH_SEEDS[0]}-{BATCH_SEEDS[-1]}, energy) degraded under "
        f"{', '.join(FAIL_PRESETS)}, re-solved warm from its healthy "
        f"results and cold ({card})")
    t_phase = time.perf_counter()
    fail = failure_phase(probs8, batch, dev, sms, FAIL_BF16_PRESETS)
    say(f"    pdhg_burst launches on this phase's ensembles: "
        f"{fail['launches']}; pdhg_burst_bf16: {fail['bf16_launches']}; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    require(fail["launches"] > 0 and fail["bf16_launches"] > 0,
            "phase 19 did not go through the kernels")

    # -- phase 20: online arrivals ------------------------------------------
    say("[20] online arrivals: run_online on the card")
    t_phase = time.perf_counter()
    online = online_phase(dev)
    say(f"    pdhg_burst launches on this phase's runs: "
        f"{online['launches']}; phase {time.perf_counter() - t_phase:.1f} s")
    require(online["launches"] > 0, "phase 20 did not go through the kernel")

    # -- phase 21: chaos replay ---------------------------------------------
    say("[21] chaos replay: the storm preset over phase 20's traces")
    t_phase = time.perf_counter()
    chaos_launches = chaos_phase(online, dev)
    say(f"    pdhg_burst launches on this phase's runs: {chaos_launches}; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    require(chaos_launches > 0, "phase 21 did not go through the kernel")

    # -- phase 22: the sweep's new axes and the collective plan ------------
    say("[22] the sweep's --failures, --arrivals and --chaos axes and "
        "plan_collectives on the card")
    t_phase = time.perf_counter()
    axes_launches = sweep_axes_phase(dev)
    say(f"    pdhg_burst launches on this phase's runs: {axes_launches}; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    require(axes_launches > 0, "phase 22 did not go through the kernel")

    # -- phase 23: baseline policies ----------------------------------------
    say(f"[23] baseline policies beside the LP on the card ({card})")
    t_phase = time.perf_counter()
    policy_launches = policy_phase(dev, p_full, full_lp["energy"],
                                   full_lp_s["energy"])
    say(f"    pdhg_burst launches on this phase: {policy_launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    require(policy_launches > 0, "phase 23 did not go through the kernel")

    # -- phase 24: placement search -----------------------------------------
    say(f"[24] placement search on the card ({card})")
    t_phase = time.perf_counter()
    placement = placement_phase(dev)
    say(f"    pdhg_burst launches on this phase: {placement['launches']}; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    require(placement["launches"] > 0, "phase 24 did not go through the "
                                       "kernel")

    # -- phase 25: the multi-tenant service ---------------------------------
    say(f"[25] the multi-tenant scheduler service on the card ({card})")
    t_phase = time.perf_counter()
    service_launches = service_phase(dev)
    say(f"    pdhg_burst launches on this phase: {service_launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    require(service_launches > 0, "phase 25 did not go through the kernel")
    new_launches = policy_launches + placement["launches"] + service_launches
    path_launches = (full_launches + fail["launches"] + online["launches"]
                     + chaos_launches + axes_launches + new_launches)
    path_bf16 = bf16_launches + fail["bf16_launches"]
    say(f"    pdhg_burst launches on the main paths: {path_launches} (phase "
        f"5 {full_launches}, phases 19-22 "
        f"{path_launches - full_launches - new_launches}, phases 23-25 "
        f"{new_launches}); pdhg_burst_bf16: {path_bf16} (phase 12 "
        f"{bf16_launches}, phase 19 {fail['bf16_launches']}); total "
        f"{time.perf_counter() - t_start:.1f} s")

    # -- phases 26-27: the rest of the model zoo ------------------------------
    t_phase = time.perf_counter()
    zoo = zoo_phase(card)
    fa_launches = serve_launches + zoo["launches"]
    say(f"    flash_attention launches on the serving paths: {fa_launches} "
        f"(phase 9 {serve_launches}, phase 26 {zoo['launches']} a prefill "
        f"of each config); phases 26-27 {time.perf_counter() - t_phase:.1f} "
        f"s; total {time.perf_counter() - t_start:.1f} s")

    # -- phases 28-29: training ---------------------------------------------
    t_phase = time.perf_counter()
    ops.FLASH_ATTENTION_LAUNCHES = 0
    ops.RGLRU_SCAN_LAUNCHES = 0
    ops.PDHG_BURST_LAUNCHES = 0
    ops.PDHG_COO_LAUNCHES = 0
    train_phase(card)
    say(f"    training launched flash_attention {ops.FLASH_ATTENTION_LAUNCHES}"
        f" and rglru_scan {ops.RGLRU_SCAN_LAUNCHES} times (it runs the "
        f"einsum path: no kernel has a backward), pdhg_coo_burst "
        f"{ops.PDHG_COO_LAUNCHES} and pdhg_burst {ops.PDHG_BURST_LAUNCHES} "
        f"(the launcher's co-flow plan, in the default lowering); phases "
        f"28-29 {time.perf_counter() - t_phase:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    require(ops.FLASH_ATTENTION_LAUNCHES == 0
            and ops.RGLRU_SCAN_LAUNCHES == 0,
            "training went through a kernel that has no backward")

    # -- phases 30-31: the row-sharded solve, the scheduled all-reduce -------
    t_phase = time.perf_counter()
    split_entries, shard_results = shard_phase(
        card, dev, p_full, lp_full,
        {name: paper_fp32[name, "energy"] for name in PAPER_TOPOS},
        full_fp32["energy"], library_ms)
    say(f"    phases 30-31 {time.perf_counter() - t_phase:.1f} s (the "
        f"ranks' phase 32(c) "
        f"{max(r['sharded']['seconds'] for r in shard_results):.1f} s "
        f"among them); total {time.perf_counter() - t_start:.1f} s")

    # -- phase 32: the sharded steps --------------------------------------
    t_phase = time.perf_counter()
    sharded = sharded_phase(card, dev, shard_results, helpers)
    fa_launches += sharded["serve_launches"] + sharded["rank_launches"]
    fa_max_err = max(fa_max_err, sharded["tp_err"])
    say(f"    flash_attention launches through the DTensor wrapper: "
        f"{sharded['serve_launches']} in (b), {sharded['rank_launches']} "
        f"on (c)'s ranks; phase 32 {time.perf_counter() - t_phase:.1f} s "
        f"here ({card}); total {time.perf_counter() - t_start:.1f} s")

    # -- phase 33: the COO lowering ----------------------------------------
    coo_entry = coo_phase(card, dev, sms, p_full, lp_full, probs8, lps8,
                          paper_fp32, full_fp32, library_ms, library8_ms)

    # -- phase 34: the examples ---------------------------------------------
    examples_phase(card, dev, helpers)

    kernels = {"kernels": [{
        "name": "pdhg_burst", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": path_launches,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}, {
        "name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
        "replaces": FA_REPLACES, "launches": fa_launches,
        "max_abs_err": fa_max_err, "ms": fa_ms, "plain_ms": fa_plain_ms,
        "bound_ms": fa_bound_ms, "bound_by": fa_bound_by,
        "library_ms": fa_lib_ms}, fa32_entry, {
        "name": "pdhg_burst_bf16", "route": "cuda", "source": SOURCE,
        "replaces": BF16_REPLACES, "launches": path_bf16,
        "max_abs_err": bf16_max_err, "ms": bf16_ms,
        "plain_ms": bf16_plain_ms, "bound_ms": bf16_bound_ms,
        "bound_by": bf16_bound_by, "library_ms": library_ms}, {
        "name": "rglru_scan", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": SCAN_REPLACES, "launches": scan_launches,
        "max_abs_err": scan_max_err, "ms": scan_ms,
        "plain_ms": scan_plain_ms, "bound_ms": scan_bound_ms,
        "bound_by": scan_bound_by, "library_ms": None}, coo_entry]
        + split_entries}
    phase_clock(None)
    early = sum(v for k, v in PHASE_WALLS.items() if int(k) <= 18)
    say("walls by phase (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(PHASE_WALLS.items(),
                                          key=lambda kv: int(kv[0])))
        + f"; phases 1-18 {early:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_helpers()
