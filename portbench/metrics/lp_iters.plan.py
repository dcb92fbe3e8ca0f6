"""PDHG iterations a plan: `FastPathResult.iterations`, the program's
count, summed over the traced window's plans, over its plans."""


def read(t):
    if not t.get("plans"):
        return None
    return t["iterations"] / t["plans"]
