"""What the drivers share: the spans of a plan's layers, the record of
each solve, and the reference's judgement of the recorded solves."""
from __future__ import annotations

import sys
import time

import numpy as np

from portbench import gen, roofline
from portbench.reference import model


def sync(ctx) -> None:
    if ctx.device != "cpu":
        import torch
        torch.cuda.synchronize()


def shape(mix: dict) -> dict:
    """A plan mix's shuffle shape, as gen.shuffle takes it."""
    return {k: mix[k] for k in ("n_map", "n_reduce", "total_gbits", "skew",
                                "placement")}


def control_kw(ctx) -> dict:
    """The program's lower-precision path: bf16-stored PDHG iterates,
    which exist only under the blocked-ELL lowering."""
    return dict(backend="pallas", precision="bf16") if ctx.control else {}


def instrument_plan(ctx) -> None:
    """Spans around the solver's layers, and the COO kernel's iterations
    counted at its entry point."""
    S, P = ctx.spans, ctx.P
    S.wrap(P.solver, "build_routing_lp", "build")
    S.wrap(P.solver, "solve_lp", "lp")
    S.wrap(P.solver, "solve_lp_batch", "lp")
    for name in ("path_decompose", "temporal_pack", "evaluate"):
        S.wrap(P.solver, name, "pack")
    burst = P.ops.pdhg_coo_burst

    def counted(*a, iters, **kw):
        ctx.counters["coo_iters"] = ctx.counters.get("coo_iters", 0) + iters
        return burst(*a, iters=iters, **kw)
    S.patch(P.ops, "pdhg_coo_burst", counted)


def solution(p, objective: str, r) -> dict:
    """What the reference judges of one solve: the problem's inputs as
    the program was handed them, and the program's answer (its LP
    solution and duals by row name, its schedule, its reported
    objective).  The schedule is kept as it is and made sparse after the
    window (`judge_solution`)."""
    cf = p.coflow
    idx = r.index
    return dict(
        src=np.asarray(cf.src, dtype=np.int64),
        dst=np.asarray(cf.dst, dtype=np.int64),
        size=np.asarray(cf.size, dtype=np.float64),
        path_slack=p.path_slack, rho=float(p.rho), objective=objective,
        schedule=r.schedule,
        lp_x=None if r.lp_x is None else np.array(r.lp_x),
        lp_y=None if r.lp_y is None else np.array(r.lp_y),
        row_keys=(None if idx is None or idx.eq_keys is None
                  else idx.eq_keys + idx.ub_keys),
        energy_j=float(r.metrics.energy_j),
        completion_s=float(r.metrics.completion_s))


def judge_solution(fab, k: dict) -> dict:
    """The reference's readings of one solve (`solution`): the schedule's
    worst residual over every family, its flows' demand included
    ("feasibility_gbit", and its family), the reported
    objective against the reference's re-scoring ("rescore_rel"), the
    LP solution's worst row or bound violation on the reference's own LP
    ("lp_residual_gbit"), its value over the duals' weak-duality bound,
    less 1 ("lp_dual_gap_rel"), and the exact objective over that bound
    ("gap")."""
    src, dst, size = k["src"], k["dst"], k["size"]
    mask = model.admissible(fab, src, dst, k["path_slack"])
    entries = model.dense_to_entries(k["schedule"])
    sc = model.check_schedule(fab, src, dst, size, mask, entries,
                              rho=k["rho"])
    lpc = model.lp_check(fab, src, dst, size, mask, entries[-1][3],
                         k["objective"], k["rho"], k["lp_x"], k["lp_y"],
                         k["row_keys"])
    bound = lpc.get("bound", -np.inf)
    fam = max(sc["residuals"], key=sc["residuals"].get)
    got = sc["completion_s"] if k["objective"] == "time" else sc["energy_j"]
    return dict(
        feasibility_gbit=sc["residuals"][fam], family=fam,
        rescore_rel=max(_rel(k["energy_j"], sc["energy_j"]),
                        _rel(k["completion_s"], sc["completion_s"])),
        lp_residual_gbit=lpc["residual"],
        lp_dual_gap_rel=_rel(lpc["value"], bound),
        # over the LP's certified lower bound; a bound of nought or below
        # certifies nothing
        gap=got / max(bound, 1e-9 * got, 1e-300),
        entries=entries, mask=mask)


READINGS = ("feasibility_gbit", "rescore_rel", "lp_residual_gbit",
            "lp_dual_gap_rel")


def worst(readings: list, limits: dict, names=READINGS) -> dict:
    """Each reading's worst over the solves judged, beside its limit;
    with none judged, no answer (inf)."""
    checks = {}
    for name in names:
        v = max((r[name] for r in readings), default=np.inf)
        checks[name] = {"value": float(v), "limit": float(limits[name])}
    if readings:
        fam = max(readings, key=lambda r: r["feasibility_gbit"])["family"]
        print(f"worst feasibility family: {fam}", file=sys.stderr)
    return checks


class PlanState:
    """Every plan of the window, kept for the reference, which judges
    them all once the window has closed."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.sites = gen.Sites(ctx.arrays)
        self.gap_plans = int(ctx.cell.mix["gap_plans"])
        self.kept: dict = {}
        self.traced: list = []
        self.failed = 0
        self.iterations = 0

    def record(self, i, p, r, cert, *, timed=True) -> None:
        ctx = self.ctx
        if timed:
            self.failed += int(not cert.ok)
            self.iterations += int(r.iterations)
            if ctx.trace:
                self.traced.append((i, ctx.counters.pop("coo_iters", 0)))
        self.kept[i] = solution(p, ctx.cell.mix["objective"], r)

    def window_result(self, n: int, spent: float) -> dict:
        return {"attempted": n, "failed": self.failed,
                "end_to_end": {"plan_s": spent / max(n, 1)},
                "trace": {"plans": n, "iterations": self.iterations}}

    def judge(self, limits: dict, window: dict):
        t0 = time.perf_counter()
        fab = self.ctx.fab
        readings = {i: judge_solution(fab, self.kept[i])
                    for i in sorted(self.kept)}
        print(f"reference: {len(readings)} plans judged in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        checks = worst(list(readings.values()), limits)
        if self.traced:
            self._roofline(readings, window)
        gaps = [readings[i]["gap"] for i in range(self.gap_plans)]
        return checks, {"plan_gap": float(np.mean(gaps))}

    def _roofline(self, readings, window) -> None:
        """Each traced plan's least COO time: its kernel iterations times
        one iteration's least time at the reference LP's size."""
        peaks = window.get("peaks")
        least = 0.0
        for i, iters in self.traced:
            k, mask = self.kept[i], readings[i]["mask"]
            n, m, nnz = model.lp_size(self.ctx.fab, k["src"], k["dst"],
                                      k["size"], mask,
                                      readings[i]["entries"][-1][3],
                                      k["objective"], k["rho"])
            least += iters * roofline.coo_iteration_s(n, m, nnz, peaks)
        window["trace"]["coo_least_s"] = least


def _rel(a: float, b: float) -> float:
    """|a - b| over |b|; inf where b is not finite."""
    if not np.isfinite(b):
        return np.inf
    return abs(a - b) / max(abs(b), 1e-12)


