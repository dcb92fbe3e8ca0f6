"""The PDHG solve (`solver.solve_lp`, `solve_lp_batch`), host and card,
seconds a plan: the self time of the "lp" spans over the traced window,
over its plans."""


def read(t):
    s = t["spans"].get("lp")
    if s is None or not t.get("plans"):
        return None
    return s / t["plans"]
