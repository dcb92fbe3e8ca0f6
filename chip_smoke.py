#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and hold its kernel to account.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    PYTHONPATH=src python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit code:

  1. card check: a CUDA device, its name and power limit, TF32 off;
  2. build: the CUDA burst kernel from src/repro_torch/kernels/csrc;
  3. kernel vs plain version on the card: random blocked-ELL operators
     (frozen coordinates, a mix of inequality rows) and the full-size LP;
  4. main path, paper topologies: solve_fast on the card for six paper
     DCNs x {energy, time}; certificates, agreement with the port's own
     CPU solve, and the committed pins of tests/golden/metrics.json;
  5. main path at full size: fat-tree k=16 (1,024 servers) x {energy,
     time}, each solved twice on the card; certificates, bitwise repeat,
     and the kernel's launch count;
  6. times at the full-size shapes: the kernel, its plain version, two
     CSR mat-vecs as a library yardstick, and the bound.

The last lines are one JSON object describing the kernel, the card's
name and power limit, and `{"ok": true, "device": {...}}`.  Imports
torch, numpy and repro_torch only.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time
import warnings

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
SOURCE = "src/repro_torch/kernels/csrc/pdhg_burst.cu"


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
    from repro_torch.core import timeslot, topology, traffic
    topo = topology.build(topo_name, **topo_kw)
    cf = traffic.generate(topo, traffic.pattern("uniform", **traffic_kw), 0)
    return timeslot.ScheduleProblem(
        topo, cf, n_slots=timeslot.suggest_n_slots(topo, cf),
        path_slack=slack)


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


def compare_burst(label, op, args, iters) -> float:
    """Run the kernel and the plain version on the same card inputs;
    returns the largest absolute difference over (x, y, worst)."""
    import torch
    from repro_torch.kernels import ops, pdhg_spmv
    kw = dict(row_meta=op.rows.meta, col_meta=op.cols.meta, iters=iters)
    k = ops.pdhg_burst(*args, **kw)
    p = pdhg_spmv.pdhg_update_burst(args[12], args[13], *args[:12], **kw)
    torch.cuda.synchronize()
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
    return worst_err


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


def burst_bound(op, nnz: int) -> tuple[float, str, int, int]:
    """Least time of one PDHG iteration on this card: each operand of
    the iteration read once and each output written once (ELL tables
    and their block meta, the x-side and y-side vectors and masks; x'
    and y' written), against the operations the real entries need (a
    multiply and an add per nonzero in each direction, plus the
    elementwise updates).  Returns (ms, bound_by, bytes, ops)."""
    f4, b1, i8 = 4, 1, 8
    tables = 8 * (len(op.rows.idx) + len(op.cols.idx))
    meta = (i8 + f4) * (len(op.rows.widths) + len(op.cols.widths))
    # x side: c, tau, xmax, x (read), keep_n (read), x' (write)
    xside = op.n_pad * (4 * f4 + b1 + f4)
    # y side: q, sig, y (read), ub, keep_m (read), y' (write)
    yside = op.m_pad * (3 * f4 + 2 * b1 + f4)
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
    one profiled solve_fast against its unprofiled wall."""
    from repro_torch.core import solver, verify
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
    busy = profile_device(lambda: solver.solve_fast(p, "energy",
                                                    device=dev))
    if busy is None:
        say("    device busy share: not measured (the profiler saw no "
            "device time)")
        return
    busy_s = sum(us for _, us in busy.values()) * 1e-6
    say(f"    device busy {busy_s:.3f} s of a {wall:.3f} s solve_fast "
        f"(idle share {1.0 - busy_s / wall:.3f}); by kernel: "
        + ", ".join(f"{k} x{c} {us * 1e-3:.1f} ms"
                    for k, (c, us) in sorted(busy.items())))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.core import solver, verify
    from repro_torch.kernels import build, ops

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

    # -- phase 2: build ----------------------------------------------------
    build.load("pdhg_burst.cu")
    info = build.BUILD_INFO["pdhg_burst.cu"]
    say(f"[2] built pdhg_burst.cu in {info['seconds']:.3f} s -> "
        f"{pathlib.Path(info['library']).name}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            say(f"    ptxas: {line.strip()}")

    # -- phase 3: kernel vs plain version ----------------------------------
    say("[3] kernel vs plain version on the card")
    errs = []
    for seed, (m, n, m_eq) in enumerate([(300, 250, 120), (1025, 777, 600)]):
        op, args = random_burst_args(seed, m, n, m_eq, dev)
        for iters in (1, 500):
            errs.append(compare_burst(f"random#{seed} m={m} n={n}", op,
                                      args, iters))
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
        errs.append(compare_burst("fat-tree-k16", op_full, args_full, iters))
    max_abs_err = max(errs)

    # -- phase 4: main path on the paper topologies ------------------------
    say("[4] main path: six paper topologies x {energy, time}")
    golden = json.loads(GOLDEN.read_text())
    ops.PDHG_BURST_LAUNCHES = 0
    paper_launches = 0
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
        a, b = runs
        require(np.array_equal(a.lp_x, b.lp_x)
                and np.array_equal(a.lp_y, b.lp_y)
                and np.array_equal(a.schedule, b.schedule),
                f"fat-tree-k16/{obj}: two runs differ")
        say(f"    {obj:6s} two runs bitwise identical (lp_x, lp_y, "
            f"schedule)")
    full_launches = ops.PDHG_BURST_LAUNCHES
    say(f"    pdhg_burst launches on this phase: {full_launches} bursts, "
        f"{2 * full_iters + full_launches} CUDA kernel launches "
        f"({full_iters} PDHG iterations)")
    require(full_launches > 0, "phase 5 did not go through the CUDA kernel")
    stage_breakdown(p_full, dev)

    # -- phase 6: times ----------------------------------------------------
    say(f"[6] times per PDHG iteration at the full-size shapes ({card})")
    kw = dict(row_meta=op_full.rows.meta, col_meta=op_full.cols.meta)
    n_k, n_p = 2000, 20
    ms = sorted(time_events(lambda: ops.pdhg_burst(*args_full, iters=n_k,
                                                   **kw), 1) / n_k
                for _ in range(3))[1]
    from repro_torch.kernels import pdhg_spmv
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
    say(f"    kernel  {ms:.6f} ms/iter (burst of {n_k}, median of 3)")
    say(f"    plain   {plain_ms:.6f} ms/iter (burst of {n_p})")
    say(f"    library {library_ms:.6f} ms per K.x + K^T.y pair "
        f"(torch CSR matmul)")
    say(f"    bound   {bound_ms:.6f} ms/iter ({bound_by}: {nbytes} B at "
        f"3.35 TB/s, {nops} fp32 ops at 67 TFLOP/s)")
    per_launch = profile_device(lambda: ops.pdhg_burst(
        *args_full, iters=200, **kw))
    if per_launch is None:
        say("    per-kernel device time: not measured (the profiler saw no "
            "device time)")
    for name, (count, us) in sorted((per_launch or {}).items()):
        say(f"    profiler: {name} x{count}: {us / count:.3f} us a launch")
    say(f"    total {time.perf_counter() - t_start:.1f} s")

    kernels = {"kernels": [{
        "name": "pdhg_burst", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": full_launches,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
