"""LP assembly (`solver.build_routing_lp`), seconds a plan: the self time
of the "build" spans over the traced window, over its plans."""


def read(t):
    s = t["spans"].get("build")
    if s is None or not t.get("plans"):
        return None
    return s / t["plans"]
