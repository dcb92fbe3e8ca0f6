#!/usr/bin/env python3
"""Time the bf16 attention kernel at other tile sizes, on one CUDA card.

The tensor-core entry of src/repro_torch/kernels/csrc/flash_attention.cu
picks one (HDP, BKV, MINB) template per padded head dim: BKV keys a K/V
tile, at least MINB resident blocks an SM.  This script builds copies of
the source whose dispatch for hd 128 and hd 256 names other templates (one
nvcc each, started together, into kernels/_build/tiles/), holds each
against the plain version on ragged, windowed, softcapped and non-causal
cases, and times each at the two serving shapes of chip_smoke.py
(phi4-mini: q (4, 2048, 24, 128), causal; recurrentgemma-2b: q (4, 4096,
10, 256), one kv head, window 2048) beside torch's SDPA, in two rounds of
opposite order.  Run from the root of a checkout:

    PYTHONPATH=src python3 tools/attention_tiles.py \\
        [--tiles128 "32,4 64,2 16,4"] [--tiles256 "16,3 32,2 16,2"]

Each line names the template, its ptxas registers and spills, the median
ms a launch of 3 runs of 10, the useful TFLOP/s (4 hd flop an unmasked
pair) and the ratio to SDPA.  Exits 1 without a card, or when a variant
fails to build or to agree with the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# hd -> (serving shape (B, S, H, Hkv, window), checks (B, S, H, Hkv, hd,
# window, softcap, causal))
SHAPES = {
    128: ((4, 2048, 24, 8, 0),
          [(2, 1000, 8, 2, 128, 0, 0.0, True),
           (2, 512, 4, 4, 128, 0, 50.0, True),
           (1, 2000, 4, 2, 120, 300, 0.0, True),
           (2, 1000, 6, 2, 80, 0, 0.0, False)]),
    256: ((4, 4096, 10, 1, 2048),
          [(2, 1000, 2, 1, 256, 300, 0.0, True),
           (1, 1000, 4, 1, 256, 300, 30.0, False)]),
}


def build_variants(tiles: dict[int, list[str]]) -> dict:
    """{(hd, "BKV, MINB"): (flash_attention_fwd, ptxas line)}"""
    from chip_smoke import ptxas_templates
    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention.cu").read_text()
    out = build.BUILD_DIR / "tiles"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for hd, choices in tiles.items():
        line = re.search(rf"launch_tc<{hd}, \d+, \d+>", src)
        if line is None:
            raise SystemExit(f"no hd-{hd} dispatch line in the source")
        for c in choices:
            name = f"hd{hd}_" + c.replace(", ", "_")
            path = out / f"{name}.cu"
            path.write_text(src.replace(line.group(0),
                                        f"launch_tc<{hd}, {c}>"))
            jobs.append((hd, c, path))

    def compile_one(job):
        hd, c, path = job
        r = subprocess.run([build.nvcc_path(),
                            *build.SOURCE_FLAGS["flash_attention.cu"], "-o",
                            str(path.with_suffix(".so")), str(path)],
                           capture_output=True, text=True)
        return job, r.returncode, r.stdout + r.stderr

    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(compile_one, jobs))
    fns = {}
    for (hd, c, path), rc, log in built:
        if rc:
            raise SystemExit(f"nvcc failed on {path}:\n{log}")
        tag = f"flash_fwd_tc<{hd}, {c}>"
        info = [t for t in ptxas_templates(log) if t.startswith(tag)]
        fn = ctypes.CDLL(str(path.with_suffix(".so"))).flash_attention_fwd
        fn.argtypes = ([ctypes.c_int] * 9 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        fns[(hd, c)] = (fn, info[0] if info else tag)
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles128", default="32,4 64,2 16,4",
                    help="BKV,MINB pairs to build for hd 128")
    ap.add_argument("--tiles256", default="16,3 32,2 16,2",
                    help="BKV,MINB pairs to build for hd 256")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("attention_tiles: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import ops

    tiles = {128: [p.replace(",", ", ") for p in args.tiles128.split()],
             256: [p.replace(",", ", ") for p in args.tiles256.split()]}
    fns = build_variants(tiles)
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ok = True
    for hd, ((B, S, H, Hkv, w), checks) in SHAPES.items():
        for c in tiles[hd]:
            fn, info = fns[(hd, c)]
            print(f"ptxas: {info}", flush=True)
            with use_build(ops, fn):
                for seed, (b, s, h, hkv, d, win, cap, causal) in enumerate(
                        checks):
                    q, k, v = cs.fa_inputs(seed, b, s, h, hkv, d,
                                           torch.bfloat16, dev)
                    try:
                        cs.compare_attention(
                            f"<{hd}, {c}> S={s} hd={d} w={win}", q, k, v,
                            win, cap, causal)
                    except AssertionError as e:
                        print(f"FAILED: {e}", flush=True)
                        ok = False
        q, k, v = cs.fa_inputs(99, B, S, H, Hkv, hd, torch.bfloat16, dev)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if w:
            kt, vt = (t.repeat_interleave(H // Hkv, 1) for t in (kt, vt))
            i = torch.arange(S, device=dev)
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < w)
            lib = lambda: sdpa(qt, kt, vt, attn_mask=mask)  # noqa: E731
        else:
            lib = lambda: sdpa(qt, kt, vt, is_causal=True,  # noqa: E731
                               enable_gqa=True)
        _, _, _, flop = cs.attention_bound(B, S, H, Hkv, hd, w, 2)
        for rnd, order in enumerate((tiles[hd], tiles[hd][::-1])):
            lib_ms = cs.time_events(lib, 10)
            print(f"hd {hd} round {rnd}: SDPA {lib_ms:.6f} ms", flush=True)
            for c in order:
                with use_build(ops, fns[(hd, c)][0]):
                    ms = sorted(cs.time_events(
                        lambda: ops.flash_attention(q, k, v, window=w), 10)
                        for _ in range(3))[1]
                print(f"hd {hd} round {rnd}: <{hd}, {c}> {ms:.6f} ms, "
                      f"{flop / ms * 1e-9:.3f} TFLOP/s useful, "
                      f"{ms / lib_ms:.3f}x SDPA", flush=True)
        del q, k, v, qt, kt, vt
    return 0 if ok else 1


def use_build(ops, fn):
    """Route ops.flash_attention's CUDA launches to another build."""
    return mock.patch.object(ops, "_flash_fn", lambda: fn)


if __name__ == "__main__":
    sys.exit(main())
