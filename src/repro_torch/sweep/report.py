"""Result emission: per-instance CSV + paper-style markdown tables.

A copy of the reference's repro.sweep.report (numpy and the standard
library only), so the port's CSV and markdown are byte-compatible with
the reference's; tests/test_torch_sweep.py holds the two equal.

The markdown layout mirrors the paper's §VI comparisons (Figs. 6-14):
one table per objective, topologies as rows, traffic patterns as column
groups, mean +/- std over the seed vector for energy and completion.
Degraded-fabric records (SweepRecord.failure != "none") get their own
survivability table — capacity lost, Gbits delivered, and the degraded
E/M — aggregated over patterns and seeds.  Online-arrival records
(SweepRecord.arrivals != "none", the rolling-horizon driver) likewise
get their own table — epochs, mean co-flow response time, backlog —
and are excluded from the offline E/M grids.  Baseline-policy records
(SweepRecord.policy != "lp") feed only the optimal-vs-practical gap
table, one row per topology × policy × failure per objective.

Units in every emitted table and CSV row follow the paper exactly:
E columns are Joules from the activity-power accounting of eqs.
(19)-(22) (per-device ON power p_max plus the eps NIC-offload J/Gbit
term), M columns are seconds from the completion-time equations
(39)-(45), volumes are Gbits and capacities Gbps (Tables II-III).
Every number is core.timeslot.evaluate applied to the packed schedule
— the same single source of truth both solver backends report through;
docs/REPRODUCING.md carries the field-by-field CSV glossary.
"""
from __future__ import annotations

import csv
import dataclasses
import pathlib
from collections import defaultdict

import numpy as np

from .runner import SweepRecord

CSV_FIELDS = [f.name for f in dataclasses.fields(SweepRecord)]


def write_csv(records: list[SweepRecord], path) -> pathlib.Path:
    """One row per solved instance, fields in SweepRecord order (see the
    glossary in docs/REPRODUCING.md §5).  None fields — the oracle_*
    columns of instances that were not spot-checked — are emitted as
    empty cells, never as 0."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=CSV_FIELDS)
        w.writeheader()
        for r in records:
            row = dataclasses.asdict(r)
            w.writerow({k: ("" if row[k] is None else row[k])
                        for k in CSV_FIELDS})
    return path


def _fmt(mean: float, std: float, digits: int = 1) -> str:
    return f"{mean:.{digits}f} ± {std:.{digits}f}"


def write_markdown(records: list[SweepRecord], path) -> pathlib.Path:
    """Paper-style summary: per objective, a topology x pattern grid of
    "E (J)" (eqs. 19-22) and "M (s)" (eqs. 39-45) as mean ± std over
    seeds; plus the degraded-fabric survivability table and the oracle
    spot-check table when those record kinds are present."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    online = [r for r in records
              if r.arrivals != "none" and r.chaos == "none"]
    chaos_rows = [r for r in records if r.chaos != "none"]
    # baseline-policy rows (r.policy != "lp") feed only the gap table,
    # placement-search rows only the placement table — mixing either
    # into the E/M grids would pollute the LP means
    offline = [r for r in records
               if r.arrivals == "none" and r.policy == "lp"
               and r.placement_search == "none"]
    policy_rows = [r for r in records if r.policy != "lp"]
    placement_rows = [r for r in records if r.placement_search != "none"]
    degraded = [r for r in offline if r.failure != "none"]
    healthy = [r for r in offline if r.failure == "none"]
    by_key: dict[tuple, list[SweepRecord]] = defaultdict(list)
    for r in healthy:
        by_key[(r.objective, r.topo, r.pattern)].append(r)
    objectives = sorted({r.objective for r in records})
    topos = list(dict.fromkeys(r.topo for r in records))
    patterns = list(dict.fromkeys(r.pattern for r in records))
    n_seeds = len({r.seed for r in records})

    lines = ["# Co-flow scheduling sweep", ""]
    if records:
        r0 = records[0]
        lines += [f"{r0.n_flows} flows per co-flow "
                  f"({r0.total_gbits:g} Gbit shuffle), "
                  f"{n_seeds} seeds per cell; metrics are exact "
                  "`core.timeslot.evaluate` numbers for the fast-path "
                  "schedule (paper eqs. 19-45).", ""]
    for obj in objectives:
        lines.append(f"## Objective: min-{obj}")
        lines.append("")
        header = "| topology |"
        rule = "|---|"
        for pt in patterns:
            header += f" {pt}: E (J) | {pt}: M (s) |"
            rule += "---|---|"
        lines += [header, rule]
        for topo in topos:
            row = f"| {topo} |"
            for pt in patterns:
                rs = by_key.get((obj, topo, pt), [])
                if not rs:
                    row += " – | – |"
                    continue
                e = np.array([r.energy_j for r in rs])
                m = np.array([r.completion_s for r in rs])
                flag = "" if all(r.feasible for r in rs) else " ⚠"
                row += (f" {_fmt(e.mean(), e.std())}{flag} "
                        f"| {_fmt(m.mean(), m.std(), 3)} |")
            lines.append(row)
        lines.append("")

    if degraded:
        lines += ["## Degraded fabrics (failure scenarios)", "",
                  "Warm-started incremental re-solves "
                  "(`core.solver.solve_fast_ensemble`); capacity lost is "
                  "the fraction of aggregate Gbps removed, survivability "
                  "the Gbits delivered over the healthy demand.  Mean ± "
                  "std over patterns × seeds.", ""]
        fails = list(dict.fromkeys(r.failure for r in degraded))
        by_fk: dict[tuple, list[SweepRecord]] = defaultdict(list)
        for r in degraded:
            by_fk[(r.objective, r.topo, r.failure)].append(r)
        for obj in objectives:
            if not any(k[0] == obj for k in by_fk):
                continue
            lines += [f"### min-{obj}", "",
                      "| topology | failure | capacity lost | survivability "
                      "| E (J) | M (s) |",
                      "|---|---|---|---|---|---|"]
            for topo in topos:
                for fl in fails:
                    rs = by_fk.get((obj, topo, fl), [])
                    if not rs:
                        continue
                    cap = np.array([r.degradation_ratio for r in rs])
                    sv = np.array([r.survivability for r in rs])
                    e = np.array([r.energy_j for r in rs])
                    m = np.array([r.completion_s for r in rs])
                    flag = "" if all(r.feasible for r in rs) else " ⚠"
                    lines.append(
                        f"| {topo} | {fl} "
                        f"| {cap.mean():.1%} ± {cap.std():.1%} "
                        f"| {sv.mean():.1%} ± {sv.std():.1%}{flag} "
                        f"| {_fmt(e.mean(), e.std())} "
                        f"| {_fmt(m.mean(), m.std(), 3)} |")
            lines.append("")

    if policy_rows:
        lines += ["## Optimal-vs-practical gap (baseline policies)", "",
                  "Baseline schedulers (`core.policies`) run on the same "
                  "instances as the LP; `gap` is the LP-objective "
                  "functional (`core.policies.lp_cost`) of the policy's "
                  "schedule over the LP's — 1.00x means the policy tied "
                  "the optimum within solver tolerance.  Every policy "
                  "schedule carries a `core.verify.check_schedule` "
                  "feasibility certificate.  Mean ± std over patterns × "
                  "seeds.", ""]
        pols = list(dict.fromkeys(r.policy for r in policy_rows))
        p_fails = list(dict.fromkeys(r.failure for r in policy_rows))
        by_pk: dict[tuple, list[SweepRecord]] = defaultdict(list)
        for r in policy_rows:
            by_pk[(r.objective, r.topo, r.policy, r.failure)].append(r)
        for obj in objectives:
            if not any(k[0] == obj for k in by_pk):
                continue
            lines += [f"### min-{obj}", "",
                      "| topology | policy | failure | gap vs LP "
                      "| E (J) | M (s) |",
                      "|---|---|---|---|---|---|"]
            for topo in topos:
                for pol in pols:
                    for fl in p_fails:
                        rs = by_pk.get((obj, topo, pol, fl), [])
                        if not rs:
                            continue
                        g = np.array([r.gap_vs_lp for r in rs])
                        e = np.array([r.energy_j for r in rs])
                        m = np.array([r.completion_s for r in rs])
                        flag = ("" if all(r.feasible for r in rs)
                                else " ⚠")
                        lines.append(
                            f"| {topo} | {pol} | {fl} "
                            f"| {g.mean():.2f}x ± {g.std():.2f}{flag} "
                            f"| {_fmt(e.mean(), e.std())} "
                            f"| {_fmt(m.mean(), m.std(), 3)} |")
            lines.append("")

    if placement_rows:
        lines += ["## Placement search (joint placement + routing)", "",
                  "Optimized task placements (`repro.search`: SA / GA "
                  "over `core.traffic.Placement`, every generation "
                  "priced by one stacked batched LP dispatch) vs the "
                  "paper's fixed spread/packed/local placements on the "
                  "same pinned map-output sizes.  `gain` is the best "
                  "fixed placement's primary metric over the optimized "
                  "one — > 1.00x means the search strictly beat every "
                  "fixed placement; each optimized schedule carries a "
                  "`core.verify.check_schedule` certificate.  Mean ± "
                  "std over seeds.", ""]
        methods = list(dict.fromkeys(r.placement_search
                                     for r in placement_rows))
        by_sk: dict[tuple, list[SweepRecord]] = defaultdict(list)
        for r in placement_rows:
            by_sk[(r.objective, r.topo, r.placement_search,
                   r.pattern)].append(r)

        def _em(rs: list[SweepRecord]) -> str:
            if not rs:
                return "–"
            e = np.array([r.energy_j for r in rs])
            m = np.array([r.completion_s for r in rs])
            flag = "" if all(r.feasible for r in rs) else " ⚠"
            return f"{e.mean():.1f} J / {m.mean():.3f} s{flag}"

        for obj in objectives:
            if not any(k[0] == obj for k in by_sk):
                continue
            lines += [f"### min-{obj}", "",
                      "| topology | method | gain vs best fixed "
                      "| optimized E/M | spread E/M | packed E/M "
                      "| local E/M |",
                      "|---|---|---|---|---|---|---|"]
            for topo in topos:
                for method in methods:
                    opt = by_sk.get((obj, topo, method, "optimized"), [])
                    if not opt:
                        continue
                    g = np.array([r.placement_gain for r in opt])
                    cells = " | ".join(
                        _em(by_sk.get((obj, topo, method, pt), []))
                        for pt in ("optimized", "spread", "packed",
                                   "local"))
                    lines.append(f"| {topo} | {method} "
                                 f"| {g.mean():.3f}x ± {g.std():.3f} "
                                 f"| {cells} |")
            lines.append("")

    if online:
        lines += ["## Online arrivals (rolling horizon)", "",
                  "Rolling-horizon re-solves over seeded arrival traces "
                  "(`core.arrivals.run_online`): each epoch merges "
                  "in-flight residual volumes with newly arrived co-flows "
                  "and re-solves warm-started from the previous epoch's "
                  "PDHG state.  E sums the exact executed-prefix energies; "
                  "response is mean co-flow completion minus arrival.  "
                  "Mean ± std over patterns × seeds.", ""]
        by_ak: dict[tuple, list[SweepRecord]] = defaultdict(list)
        for r in online:
            by_ak[(r.objective, r.topo, r.arrivals)].append(r)
        fams = list(dict.fromkeys(r.arrivals for r in online))
        for obj in objectives:
            if not any(k[0] == obj for k in by_ak):
                continue
            lines += [f"### min-{obj}", "",
                      "| topology | arrivals | epochs | response (s) "
                      "| backlog (Gbit) | E (J) | makespan (s) |",
                      "|---|---|---|---|---|---|---|"]
            for topo in topos:
                for fam in fams:
                    rs = by_ak.get((obj, topo, fam), [])
                    if not rs:
                        continue
                    ep = np.array([r.epochs for r in rs])
                    resp = np.array([r.mean_response_s for r in rs])
                    bk = np.array([r.backlog_gbits for r in rs])
                    e = np.array([r.energy_j for r in rs])
                    m = np.array([r.completion_s for r in rs])
                    flag = "" if all(r.feasible for r in rs) else " ⚠"
                    lines.append(
                        f"| {topo} | {fam} | {ep.mean():.1f} "
                        f"| {_fmt(resp.mean(), resp.std(), 2)}{flag} "
                        f"| {_fmt(bk.mean(), bk.std(), 2)} "
                        f"| {_fmt(e.mean(), e.std())} "
                        f"| {_fmt(m.mean(), m.std(), 3)} |")
            lines.append("")

    if chaos_rows:
        lines += ["## Availability under chaos (trace-replayed failures)",
                  "",
                  "Rolling-horizon runs degraded mid-flight by seeded "
                  "failure/repair event traces (`core.chaos`, presets in "
                  "`core.chaos.PRESETS`): events apply at epoch "
                  "boundaries, stranded in-flight volume is re-routed by "
                  "the warm-start projection, disconnected demand parks "
                  "as deferred-by-failure until repair, and every "
                  "post-failure schedule carries a feasibility "
                  "certificate.  Availability is the trace-exact "
                  "fraction of the run with full capacity; recovery is "
                  "the mean failure-to-certified-replan time over rows "
                  "that had episodes.  Mean ± std over patterns × seeds; "
                  "see docs/CHAOS.md.", ""]
        by_ck: dict[tuple, list[SweepRecord]] = defaultdict(list)
        for r in chaos_rows:
            by_ck[(r.objective, r.topo, r.chaos)].append(r)
        presets = list(dict.fromkeys(r.chaos for r in chaos_rows))
        for obj in objectives:
            if not any(k[0] == obj for k in by_ck):
                continue
            lines += [f"### min-{obj}", "",
                      "| topology | chaos | availability "
                      "| stranded (Gbit) | recovery (s) "
                      "| deferred (Gbit) | E (J) | makespan (s) |",
                      "|---|---|---|---|---|---|---|---|"]
            for topo in topos:
                for preset in presets:
                    rs = by_ck.get((obj, topo, preset), [])
                    if not rs:
                        continue
                    av = np.array([r.availability for r in rs])
                    sg = np.array([r.stranded_gbits for r in rs])
                    dg = np.array([r.deferred_gbits for r in rs])
                    rec_s = np.array([r.recover_s for r in rs])
                    rec_s = rec_s[np.isfinite(rec_s)]
                    e = np.array([r.energy_j for r in rs])
                    m = np.array([r.completion_s for r in rs])
                    flag = "" if all(r.feasible for r in rs) else " ⚠"
                    ttr = (f"{rec_s.mean():.2f} ± {rec_s.std():.2f}"
                           if rec_s.size else "–")
                    lines.append(
                        f"| {topo} | {preset} "
                        f"| {av.mean():.1%} ± {av.std():.1%}{flag} "
                        f"| {_fmt(sg.mean(), sg.std(), 2)} "
                        f"| {ttr} "
                        f"| {_fmt(dg.mean(), dg.std(), 2)} "
                        f"| {_fmt(e.mean(), e.std())} "
                        f"| {_fmt(m.mean(), m.std(), 3)} |")
            lines.append("")

    checked = [r for r in records if r.oracle_gap is not None]
    if checked:
        lines += ["## Oracle spot-check (exact MILP, core.oracle)", "",
                  "| instance | objective | fast path | oracle | gap |",
                  "|---|---|---|---|---|"]
        for r in checked:
            exact = (r.oracle_energy_j if r.objective == "energy"
                     else r.oracle_completion_s)
            fail = "" if r.failure == "none" else f"+{r.failure}"
            lines.append(f"| {r.topo}{fail}/{r.pattern}/seed{r.seed} "
                         f"| min-{r.objective} | {r.primary:.4g} "
                         f"| {exact:.4g} | {r.oracle_gap:+.2%} |")
        lines.append("")
    infeasible = [r for r in records if not r.feasible]
    if infeasible:
        lines += [f"⚠ {len(infeasible)} instance(s) exceeded the paper's "
                  "feasibility tolerance; see `max_violation` in the CSV.", ""]
    path.write_text("\n".join(lines))
    return path
