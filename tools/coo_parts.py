#!/usr/bin/env python3
"""Where an iteration of the COO burst kernel goes, on one CUDA card.

src/repro_torch/kernels/csrc/pdhg_coo.cu runs each PDHG iteration as two
half-steps (the primal one summing K^T y by columns, the dual one K x̄ by
rows) with a grid barrier after each.  This script builds copies of the
source with the primal half-step, the dual half-step or both compiled out,
and a copy of one block of 1024 threads an SM instead of two of 512 (one
nvcc each, started together, into kernels/_build/parts/; the cut copies
compute nothing right and are only timed), and times each beside the
kernel itself at chip_smoke.py's shapes: the flagship's energy and
min-time LPs (fat-tree k=16, 20 x 12 shuffle) and the 8-stack of its
energy LPs (seeds 0-7), in two rounds of opposite order, each copy of
512 threads on the kernel's own grid.  The kernel and its barriers alone
are also timed on smaller grids (GRIDS blocks of 512).
Run from the root of a checkout:

    PYTHONPATH=src python3 tools/coo_parts.py

Each line names the copy and its grid, then the median ms an iteration
of 3 bursts at each shape, a round each; the last lines split the
kernel's iteration (the rounds' mean) into the two barriers (both
half-steps out) and each half-step's share (the kernel less the copy
without it).  Exits 1 without a card or when a copy fails to build.

The copies are cut by text: each pattern below must match one line of
pdhg_coo.cu (PRIMAL and DUAL the two `sums(...)` calls of the burst's
loop, which say so; THREADS the block shape's constants); an edit to
those lines makes this script exit 1 until they are updated here.  Each
copy is timed through ops.pdhg_coo_burst by putting its library in
build's cache of loaded sources in place of the kernel's.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PRIMAL = ("    sums(p.cols, y, warp", "    if (0) sums(p.cols, y, warp")
DUAL = ("    sums(p.rows, p.x_bar, warp",
        "    if (0) sums(p.rows, p.x_bar, warp")
THREADS = (("constexpr int kThreads = 512;",
            "constexpr int kThreads = 1024;"),
           ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;"))
COPIES = {"kernel": (), "no primal": (PRIMAL,), "no dual": (DUAL,),
          "barriers only": (PRIMAL, DUAL),
          "1024 threads": THREADS,
          "1024 threads, barriers only": (*THREADS, PRIMAL, DUAL)}
# smaller grids the kernel and its barriers are timed on
GRIDS = (200, 132, 100, 70)
# shape -> iterations a burst
BURSTS = {"flagship energy": 2000, "flagship time": 2000, "8-stack": 1000}


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("coo_parts: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import solver
    from repro_torch.kernels import build, ops
    src = (build.CSRC / "pdhg_coo.cu").read_text()
    out = build.BUILD_DIR / "parts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cut in COPIES.items():
        text = src
        for before, after in cut:
            if text.count(before) != 1:
                print(f"coo_parts: {before.strip()!r} not found once in the "
                      f"source", file=sys.stderr)
                return 1
            text = text.replace(before, after)
        stem = name.replace(" ", "_").replace(",", "")
        (out / f"{stem}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(out / f"{stem}.so"), str(out / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"coo_parts: {name} failed to build:\n{log}",
                  file=sys.stderr)
            return 1
        stem = name.replace(" ", "_").replace(",", "")
        libs[name] = ctypes.CDLL(str(out / f"{stem}.so"))
    dev = torch.device("cuda")
    p = cs.problem(*cs.FULL)
    lps = {"flagship energy": solver.build_routing_lp(p, "energy")[0],
           "flagship time": solver.build_routing_lp(p, "time")[0],
           "8-stack": solver.block_stack(
               [solver.build_routing_lp(q, "energy")[0]
                for q in cs.problems(*cs.FULL, cs.BATCH_SEEDS)]).lp}
    operands = {k: cs.coo_operands(lp, dev) for k, lp in lps.items()}
    starts = {k: cs.coo_start(lp, 0, False) for k, lp in lps.items()}
    build.load("pdhg_coo.cu")
    print(cs.card_line())
    # every copy of 512 threads runs on the kernel's own grid (the cut
    # copies need fewer registers, so more of their blocks would fit),
    # the 1024-thread copies on as many blocks as fit of theirs
    grid = {}
    for name in ("kernel", "1024 threads"):
        build._LOADED["pdhg_coo.cu"] = libs[name]
        grid[name] = ops.coo_max_blocks(dev)
    runs = ([(name, grid["1024 threads" if name.startswith("1024")
                         else "kernel"]) for name in COPIES]
            + [(name, b) for name in ("kernel", "barriers only")
               for b in GRIDS])
    ms: dict = {}
    for order in (runs, runs[::-1]):
        for name, blocks in order:
            build._LOADED["pdhg_coo.cu"] = libs[name]
            for shape, n in BURSTS.items():
                t = sorted(cs.time_events(lambda: cs.coo_run(
                    operands[shape], starts[shape], n, dev, blocks), 1) / n
                    for _ in range(3))[1]
                ms.setdefault((name, blocks, shape), []).append(t)
    for name, blocks in runs:
        label = f"{name} on {blocks} blocks"
        print(f"{label:42s} " + "  ".join(
            f"{shape} " + " ; ".join(f"{t:.6f}"
                                     for t in ms[name, blocks, shape])
            for shape in BURSTS) + " ms an iteration")
    for shape in BURSTS:
        def mean(name):
            t = ms[name, grid["kernel"], shape]
            return sum(t) / len(t)
        whole = mean("kernel")
        print(f"{shape}: the iteration {whole:.6f} ms on {grid['kernel']} "
              f"blocks; the two barriers {mean('barriers only'):.6f}; the "
              f"primal half-step {whole - mean('no primal'):.6f}; the dual "
              f"{whole - mean('no dual'):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
