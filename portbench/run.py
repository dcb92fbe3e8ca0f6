"""Run one cell of BENCHMARK.json once, on the card, and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  It loads the program (`repro_torch`,
from the checkout's src/), makes the cell's inputs from the seed, warms
up on the cell's own shapes, measures for `--seconds`, has the reference
judge what the window produced, and prints one JSON line last on
standard output: the end-to-end metrics (`--trace 0`) or the per-layer
ones with the device trace's breakdown (`--trace 1`).  Each number that
decides `correct` is printed beside its limit, last on standard error
and under "checks" in the line.  Without a CUDA card, or with fewer
cards than the cell asks for, it prints no result and exits 3; it exits
4 if JAX or the JAX package (`repro`) was loaded."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
THREADS = 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches at fixed paths inside the checkout
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    # the host's load from one process with few threads
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "MKL_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch
    torch.set_num_threads(THREADS)
    from portbench import harness
    cell = harness.find_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card and has no "
              "CPU fallback", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START, cell=cell)
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad[:20]}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
