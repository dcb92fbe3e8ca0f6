#!/usr/bin/env python3
"""Time the attention kernel's tile plans, or its fp32 entry, on one CUDA card.

The bf16 entry of src/repro_torch/kernels/csrc/flash_attention.cu builds
the (HDP, BKV, STAGES) templates that its FA_WGMMA_TEMPLATES line lists,
and kernels/flash_attention.py::tile_plan picks one per padded head dim
(HDP 64, 128 or 256).  This script builds copies of the source whose
FA_WGMMA_TEMPLATES line names other BKV and STAGES for a head dim (one
nvcc each, started together, into kernels/_build/tiles/), launches each
under the matching plan, holds each against the plain version on ragged,
windowed, softcapped and non-causal cases, and times each at the serving
shapes of that head dim (PERF.md rows 2-2e: phi4-mini and its TP-local
shape at hd 128, granite-moe and internvl2 at hd 64, recurrentgemma-2b at
hd 256 with one kv head and window 2048) beside torch's SDPA, in two
rounds of opposite order.  With --baseline SRC it also builds SRC, a
flash_attention.cu whose C entry takes the 16 arguments of the earlier
mma.sync kernel (no plan; the source at an earlier commit), and times it
beside the variants, so that two versions are compared in one run.  Run
from the root of a checkout:

    PYTHONPATH=src python3 tools/attention_tiles.py \\
        [--tiles64 "128,2 128,3"] [--tiles128 "128,2 64,2"] \\
        [--tiles256 "64,2"] [--baseline PATH]

Each line names the build, the median ms a launch of 3 runs of 10, the
useful TFLOP/s (4 hd flop an unmasked pair), the ratio to its bound and
the ratio to SDPA; each variant's ptxas registers and spills come first.

With --fp32 it times the fp32 SIMT entry instead (PERF.md row 2f):
the source as it stands and, with --baseline SRC, another
flash_attention.cu whose entry takes the 21 arguments of today's (the
float32 plan ignored there, as the earlier SIMT entry did), built side
by side; each held to the plain version on chip_smoke.py's fp32 cases
but the three at serving size, then each timed (median of 3 runs of 3)
in fp32 at row 2f's shape (phi4-mini), at hd 64 (row 2c's shape) and at
hd 256 (row 2b's, window 2048), beside torch's SDPA on the same fp32
operands and the bound at the fp32 FMA rate, in two rounds of opposite
order:

    PYTHONPATH=src python3 tools/attention_tiles.py --fp32 \\
        [--baseline PATH]

Exits 1 without a card, or when a build fails or a variant disagrees with
the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# padded hd -> (serving shapes (row, B, S, H, Hkv, window), checks (B, S,
# H, Hkv, hd, window, softcap, causal))
SHAPES = {
    64: ([("2c granite-moe", 4, 2048, 16, 8, 0),
          ("2d internvl2", 4, 2304, 14, 2, 0)],
         [(2, 1000, 8, 2, 64, 0, 0.0, True),
          (2, 512, 4, 4, 32, 0, 50.0, True),
          (1, 1000, 4, 1, 64, 300, 0.0, False)]),
    128: ([("2 phi4-mini", 4, 2048, 24, 8, 0),
           ("2e phi4 TP-local", 4, 2048, 12, 4, 0)],
          [(2, 1000, 8, 2, 128, 0, 0.0, True),
           (2, 512, 4, 4, 128, 0, 50.0, True),
           (1, 2000, 4, 2, 120, 300, 0.0, True),
           (2, 1000, 6, 2, 80, 0, 0.0, False)]),
    256: ([("2b recurrentgemma", 4, 4096, 10, 1, 2048)],
          [(2, 1000, 2, 1, 256, 300, 0.0, True),
           (1, 1000, 4, 1, 256, 300, 30.0, False)]),
}
ARGTYPES = ([ctypes.c_int] * 9 + [ctypes.c_float] * 2
            + [ctypes.c_void_p] * 5)
# --fp32: (row, B, S, H, Hkv, hd, window), all causal
FP32_SHAPES = [("2f phi4-mini fp32", 4, 2048, 24, 8, 128, 0),
               ("hd 64 (row 2c's shape) fp32", 4, 2048, 16, 8, 64, 0),
               ("hd 256 (row 2b's shape) fp32", 4, 4096, 10, 1, 256, 2048)]
# chip_smoke.FA_CASES left out of --fp32's checks: the serving sizes, which
# the timings run
FP32_SKIP = ("danube", "phi4-serve", "rgemma-serve")


def variant_source(src: str, hd: int, bkv: int, stages: int) -> str:
    """`src` with the FA_WGMMA_TEMPLATES entry of padded head dim `hd`
    replaced by (hd, bkv, stages)."""
    line = re.search(r"#define FA_WGMMA_TEMPLATES\(X\).*", src)
    entry = line and re.search(rf"X\({hd}, \d+, \d+\)", line.group(0))
    if entry is None:
        raise SystemExit(f"no hd-{hd} entry in the source's "
                         f"FA_WGMMA_TEMPLATES line")
    return src.replace(line.group(0), line.group(0).replace(
        entry.group(0), f"X({hd}, {bkv}, {stages})"))


def build_all(jobs: dict) -> dict:
    """{name: source text} -> {name: (library path, nvcc log)}, one nvcc
    each, started together."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR / "tiles"
    out.mkdir(parents=True, exist_ok=True)

    def compile_one(item):
        name, text = item
        path = out / f"{name}.cu"
        path.write_text(text)
        r = subprocess.run([build.nvcc_path(),
                            *build.SOURCE_FLAGS["flash_attention.cu"], "-o",
                            str(path.with_suffix(".so")), str(path)],
                           capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"nvcc failed on {path}:\n"
                             f"{r.stdout + r.stderr}")
        return name, (path.with_suffix(".so"), r.stdout + r.stderr)

    with ThreadPoolExecutor(len(jobs)) as pool:
        return dict(pool.map(compile_one, jobs.items()))


def entry(lib: pathlib.Path, plan_args: bool):
    """The library's flash_attention_fwd, as ops._attend calls it (the 16
    arguments of an entry without a plan take the first 16)."""
    fn = ctypes.CDLL(str(lib)).flash_attention_fwd
    fn.argtypes = ARGTYPES + [ctypes.c_int] * 5 * plan_args
    fn.restype = ctypes.c_int
    return fn if plan_args else (lambda *a: fn(*a[:16]))


def use_build(ops, fa, fn, tiles=None):
    """Route ops.flash_attention's CUDA launches to another build, under
    the plan {padded hd: (BKV, STAGES)} `tiles`."""
    stack = ExitStack()
    stack.enter_context(mock.patch.object(ops, "_flash_fn", lambda: fn))
    stack.enter_context(mock.patch.dict(fa._TILES, tiles or {}))
    return stack


def sdpa_call(q, k, v, window):
    """torch's SDPA on (B, S, H, hd) operands laid out as it takes them:
    causal with GQA, or, with a window, a boolean mask over kv repeated to
    every query head."""
    import torch
    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, Hkv = q.shape[2], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if not window:
        return lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    kt, vt = (t.repeat_interleave(H // Hkv, 1) for t in (kt, vt))
    i = torch.arange(q.shape[1], device=q.device)
    mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    return lambda: sdpa(qt, kt, vt, attn_mask=mask)


def fp32_main(args) -> int:
    """--fp32: the fp32 entry of the source, and of --baseline, checked
    and timed side by side."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa

    jobs = {"tree": (build.CSRC / "flash_attention.cu").read_text()}
    if args.baseline:
        jobs["baseline"] = pathlib.Path(args.baseline).read_text()
    built = build_all(jobs)
    card = cs.card_line()
    print(card, flush=True)
    builds = {}
    for name, (lib, log) in built.items():
        for line in cs.ptxas_templates(log):
            if "simt" in line:
                print(f"ptxas {name}: {line}", flush=True)
        builds[name] = entry(lib, True)
    for _, *shape in FP32_SHAPES:
        p = fa.simt_plan(shape[4])
        print(f"tree's plan at hd {shape[4]}: flash_fwd_simt<{p.hdp}, "
              f"{p.bq}, {p.bkv}, {p.stages}>, {p.threads} threads, "
              f"{p.smem} B of shared memory a block", flush=True)
    dev = torch.device("cuda", 0)
    ok = True
    for name, fn in builds.items():
        with use_build(ops, fa, fn):
            for seed, (case, b, s, h, hkv, d, win, cap, causal) in enumerate(
                    cs.FA_CASES):
                if case in FP32_SKIP:
                    continue
                q, k, v = cs.fa_inputs(seed, b, s, h, hkv, d, torch.float32,
                                       dev)
                try:
                    cs.compare_attention(f"{name} {case} hd={d} w={win}", q,
                                         k, v, win, cap, causal)
                except AssertionError as e:
                    print(f"FAILED: {e}", flush=True)
                    ok = False
    names = list(builds)
    for row, B, S, H, Hkv, hd, w in FP32_SHAPES:
        q, k, v = cs.fa_inputs(99, B, S, H, Hkv, hd, torch.float32, dev)
        lib = sdpa_call(q, k, v, w)
        bound, by, _, flop = cs.attention_bound_fp32(B, S, H, Hkv, hd, w)
        for rnd, order in enumerate((names, names[::-1])):
            lib_ms = cs.time_events(lib, 3)
            print(f"{row} round {rnd}: SDPA {lib_ms:.6f} ms; bound "
                  f"{bound:.6f} ms ({by}, 67 TFLOP/s fp32)", flush=True)
            for name in order:
                with use_build(ops, fa, builds[name]):
                    ms = sorted(cs.time_events(
                        lambda: ops.flash_attention(q, k, v, window=w), 3)
                        for _ in range(3))[1]
                print(f"{row} round {rnd}: {name} {ms:.6f} ms, "
                      f"{flop / ms * 1e-9:.3f} TFLOP/s useful, "
                      f"{ms / bound:.3f}x its bound, "
                      f"{ms / lib_ms:.3f}x SDPA", flush=True)
        del q, k, v, lib
    print(card, flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for hd in SHAPES:
        ap.add_argument(f"--tiles{hd}", default="",
                        help=f"BKV,STAGES pairs to build for hd {hd} "
                             f"(the plan's own is always built)")
    ap.add_argument("--baseline", default=None,
                    help="a flash_attention.cu to time beside the variants: "
                         "with the 16-argument entry, or with --fp32 the "
                         "21-argument one")
    ap.add_argument("--fp32", action="store_true",
                    help="time the fp32 SIMT entry (and --baseline's) "
                         "instead of the bf16 templates")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("attention_tiles: no CUDA card", file=sys.stderr)
        return 1
    if args.fp32:
        return fp32_main(args)
    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa

    src = (build.CSRC / "flash_attention.cu").read_text()
    tiles = {}
    for hd in SHAPES:
        own = fa.tile_plan(hd)
        pairs = [(own.bkv, own.stages)] + [
            tuple(int(x) for x in p.split(","))
            for p in getattr(args, f"tiles{hd}").split()]
        tiles[hd] = list(dict.fromkeys(pairs))
    jobs = {f"hd{hd}_{bkv}_{st}": variant_source(src, hd, bkv, st)
            for hd, pairs in tiles.items() for bkv, st in pairs}
    if args.baseline:
        jobs["baseline"] = pathlib.Path(args.baseline).read_text()
    built = build_all(jobs)
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    ok = True
    for hd, (serving, checks) in SHAPES.items():
        builds = {}
        for bkv, st in tiles[hd]:
            name = f"hd{hd}_{bkv}_{st}"
            lib, log = built[name]
            tag = f"flash_fwd_wgmma<{hd}, {bkv}, {st}>"
            info = [t for t in cs.ptxas_templates(log) if t.startswith(tag)]
            print(f"ptxas: {info[0] if info else tag}", flush=True)
            builds[f"<{hd}, {bkv}, {st}>"] = (entry(lib, True),
                                              {hd: (bkv, st)})
            with use_build(ops, fa, *builds[f"<{hd}, {bkv}, {st}>"]):
                for seed, (b, s, h, hkv, d, win, cap, causal) in enumerate(
                        checks):
                    q, k, v = cs.fa_inputs(seed, b, s, h, hkv, d,
                                           torch.bfloat16, dev)
                    try:
                        cs.compare_attention(
                            f"<{hd}, {bkv}, {st}> S={s} hd={d} w={win}", q,
                            k, v, win, cap, causal)
                    except AssertionError as e:
                        print(f"FAILED: {e}", flush=True)
                        ok = False
        if args.baseline:
            builds["baseline"] = (entry(built["baseline"][0], False), None)
        for row, B, S, H, Hkv, w in serving:
            q, k, v = cs.fa_inputs(99, B, S, H, Hkv, hd, torch.bfloat16, dev)
            lib = sdpa_call(q, k, v, w)
            bound, by, _, flop = cs.attention_bound(B, S, H, Hkv, hd, w, 2)
            names = list(builds)
            for rnd, order in enumerate((names, names[::-1])):
                lib_ms = cs.time_events(lib, 10)
                print(f"{row} round {rnd}: SDPA {lib_ms:.6f} ms; bound "
                      f"{bound:.6f} ms ({by})", flush=True)
                for name in order:
                    with use_build(ops, fa, *builds[name]):
                        ms = sorted(cs.time_events(
                            lambda: ops.flash_attention(q, k, v, window=w),
                            10) for _ in range(3))[1]
                    print(f"{row} round {rnd}: {name} {ms:.6f} ms, "
                          f"{flop / ms * 1e-9:.3f} TFLOP/s useful, "
                          f"{ms / bound:.3f}x its bound, "
                          f"{ms / lib_ms:.3f}x SDPA", flush=True)
            del q, k, v, lib
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
