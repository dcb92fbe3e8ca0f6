"""One caller asking for certified plans in a closed loop.

Each plan is a new shuffle from the mix's generator; the caller's path
is the whole of: the problem and its horizon
(`timeslot.ScheduleProblem`, `suggest_n_slots`), `solver.solve_fast`
(naming no backend: the default lowering), and the certificate
`verify.check_schedule`.  The window runs plans until `--seconds` of
plan time have passed, the last plan whole; `plan_s` is that time over
the plans.  Once the window has closed the reference judges every plan
of it, and `plan_gap` is the mean over its first `gap_plans` plans
(planned after the window, untimed, when it held fewer).  A plan that
the program's own certificate rejects counts as failed.

Mix keys: objective, n_map, n_reduce, total_gbits, skew, placement,
path_slack, rho, gap_plans.  With the control on, solve_fast runs the
program's bf16-storage path (backend "pallas", precision "bf16")."""
from __future__ import annotations

import time

from portbench import gen
from portbench.drivers import common


def setup(ctx):
    mix = ctx.cell.mix
    st = common.PlanState(ctx)
    st.coflow = lambda i: gen.shuffle(gen.rng(ctx.seed, "plan", i),
                                      st.sites, **common.shape(mix))
    # one plan on a shuffle of its own: kernels loaded, caches of the
    # topology filled
    src, dst, size = gen.shuffle(gen.rng(ctx.seed, "warmup"), st.sites,
                                 **common.shape(mix))
    plan(ctx, st, src, dst, size)
    common.sync(ctx)
    return st


def instrument(ctx):
    common.instrument_plan(ctx)


def plan(ctx, st, src, dst, size):
    P, mix = ctx.P, ctx.cell.mix
    with ctx.spans.span("problem"):
        cf = P.traffic.CoflowSet(src, dst, size, ctx.topo.n_vertices)
        T = P.timeslot.suggest_n_slots(ctx.topo, cf, rho=mix["rho"])
        p = P.timeslot.ScheduleProblem(ctx.topo, cf, n_slots=T,
                                       rho=mix["rho"],
                                       path_slack=mix["path_slack"])
    r = P.solver.solve_fast(p, mix["objective"], device=ctx.device,
                            **common.control_kw(ctx))
    with ctx.spans.span("cert"):
        cert = P.verify.check_schedule(p, r.schedule)
    return p, r, cert


def window(ctx, st):
    i, spent = 0, 0.0
    while spent < ctx.seconds:
        src, dst, size = st.coflow(i)
        t0 = time.perf_counter()
        p, r, cert = plan(ctx, st, src, dst, size)
        common.sync(ctx)
        spent += time.perf_counter() - t0
        st.record(i, p, r, cert)
        i += 1
    st.n_timed = i
    return st.window_result(i, spent)


def judge(ctx, st, window):
    # the plans that judge plan quality, untimed, if the window held fewer
    for j in range(st.n_timed, st.gap_plans):
        src, dst, size = st.coflow(j)
        p, r, cert = plan(ctx, st, src, dst, size)
        st.record(j, p, r, cert, timed=False)
    return st.judge(ctx.cell.limits, window)
