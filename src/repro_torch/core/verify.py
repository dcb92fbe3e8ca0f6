"""Machine-checked schedule-feasibility certificates.

A numpy copy of the reference `repro.core.verify`; verdicts are held
bitwise equal to it (tests/test_torch_problem.py).

`core.timeslot.evaluate` folds every constraint residual into a single
`max_violation` scalar — enough to report feasibility, not enough to
say *which* constraint drifted or to certify a third-party schedule
family constraint-by-constraint.  This module re-runs the same paper
equations but keeps each family's worst residual separate, producing a
`Certificate` that the LP fast path, every baseline policy
(core.policies), and the test suites all share: "policy X is 1.4x
worse than optimal" is then backed by the same machine-checked
feasibility evidence as the LP numbers it is compared against.

Families (all residuals in Gbits; a schedule is feasible iff every one
is <= tol):

  capacity       eq. (28)   psi[e,w,t] <= C_uvw * D
  egress         eq. (26)   per-server egress <= rho * D
  ingress        eq. (27)   per-switch ingress <= sigma * D
  mask           eq. (46)   no traffic on flow-inadmissible edges
  conservation   eq. (25)   per-wavelength at passive vertices,
                            wavelength-summed at electronic ones
  demand         eq. (30)   |served_f - size_f|
  release        extension  no traffic before release_slot[f]
  wavelength     eq. (47)   one TX wavelength per server per slot (PON3)

The residual definitions are kept formula-for-formula identical to
`evaluate` (tests/test_policies.py pins `max_residual` ==
`Metrics.max_violation`), so certifying a schedule can never disagree
with the metrics the sweeps report.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .timeslot import TOL, ScheduleProblem

# matches evaluate()'s feasibility threshold (Metrics.feasible)
FEASIBILITY_TOL = 1e-4

FAMILIES = ("capacity", "egress", "ingress", "mask", "conservation",
            "demand", "release", "wavelength")


@dataclasses.dataclass(frozen=True)
class Certificate:
    """Per-constraint-family worst residuals of one schedule tensor."""

    residuals: dict[str, float]   # family -> worst residual, Gbits
    tol: float

    @property
    def max_residual(self) -> float:
        return max(self.residuals.values(), default=0.0)

    @property
    def worst(self) -> str:
        if not self.residuals:
            return "none"
        return max(self.residuals, key=self.residuals.get)

    @property
    def ok(self) -> bool:
        return self.max_residual <= self.tol

    def summary(self) -> str:
        body = " ".join(f"{k}={self.residuals[k]:.3g}" for k in FAMILIES
                        if k in self.residuals)
        verdict = "ok" if self.ok else f"VIOLATED({self.worst})"
        return f"{verdict} tol={self.tol:g} {body}"

    def assert_ok(self, context: str = "") -> "Certificate":
        """Raise AssertionError naming the violated family; returns self
        so call sites can chain (`cert = check_schedule(...).assert_ok()`)."""
        if not self.ok:
            where = f" [{context}]" if context else ""
            raise AssertionError(
                f"infeasible schedule{where}: {self.worst} residual "
                f"{self.max_residual:.6g} > tol {self.tol:g} "
                f"({self.summary()})")
        return self


def check_schedule(p: ScheduleProblem, x: np.ndarray, *,
                   tol: float = FEASIBILITY_TOL) -> Certificate:
    """Certify a schedule tensor against eqs. (25)-(28), (30), (46),
    (47) and release times.  Pure numpy, deterministic; residual
    formulas are identical to `core.timeslot.evaluate`, per family."""
    F, E, W, T = p.shape_x
    assert x.shape == (F, E, W, T), (x.shape, p.shape_x)
    D = p.topo.slot_duration
    psi = x.sum(axis=0)                               # (E, W, T), eq. (29)
    res: dict[str, float] = {}

    # eq. (28): psi <= C*D (zero-capacity wavelengths must carry nothing)
    res["capacity"] = float(
        (psi - p.slot_cap_gbits[:, :, None]).max(initial=0.0))

    # eq. (26): server egress <= rho*D
    egress = np.zeros((p.topo.n_vertices, T))
    np.add.at(egress, p.e_src, psi.sum(axis=1))
    res["egress"] = float(
        (egress[p.is_server] - p.rho * D).max(initial=0.0))

    # eq. (27): switch ingress <= sigma*D
    ingress = np.zeros((p.topo.n_vertices, T))
    np.add.at(ingress, p.e_dst, psi.sum(axis=1))
    sw = p.is_switch & np.isfinite(p.sigma)
    res["ingress"] = float(
        (ingress[sw] - p.sigma[sw, None] * D).max(initial=0.0))

    # flow-edge admissibility (eq. 46 et al.)
    res["mask"] = float(
        (x * ~p.flow_edge_mask[:, :, None, None]).max(initial=0.0))

    # eq. (25): conservation at intermediate vertices — per wavelength at
    # passive (AWGR) vertices, wavelength-summed at electronic ones
    passive = ~(p.is_server | p.is_switch)
    cons = 0.0
    for f in range(F):
        net = np.zeros((p.topo.n_vertices, W, T))
        np.add.at(net, p.e_src, x[f])
        np.subtract.at(net, p.e_dst, x[f])
        inter = np.ones(p.topo.n_vertices, dtype=bool)
        inter[p.coflow.src[f]] = inter[p.coflow.dst[f]] = False
        cons = max(cons, float(np.abs(net[inter & passive]).max(initial=0.0)))
        cons = max(cons, float(np.abs(net.sum(axis=1)[inter]).max(initial=0.0)))
    res["conservation"] = cons

    # eq. (30): demand satisfaction, |served - size|
    served = np.zeros(F)
    for f in range(F):
        s = p.coflow.src[f]
        served[f] = (x[f, p.e_src == s].sum() - x[f, p.e_dst == s].sum())
    res["demand"] = float(np.abs(served - p.coflow.size).max(initial=0.0))

    # release times (extension): no traffic before a flow's release slot
    rel = 0.0
    if p.release_slot is not None:
        for f in range(F):
            r = int(p.release_slot[f])
            if r > 0:
                rel = max(rel, float(x[f, :, :, :r].max(initial=0.0)))
    res["release"] = rel

    # eq. (47): one TX wavelength per server per slot (PON3)
    wav = 0.0
    if p.topo.one_wavelength_tx and p.topo.awgr_in_ports:
        awgr_in = np.isin(p.e_dst, p.topo.awgr_in_ports)
        for i in np.flatnonzero(p.is_server):
            sel = (p.e_src == i) & awgr_in
            if sel.any():
                n_w_used = (psi[sel].sum(axis=0) > TOL).sum(axis=0)
                wav = max(wav, float(n_w_used.max(initial=0) - 1))
    res["wavelength"] = wav

    return Certificate(residuals=res, tol=tol)
