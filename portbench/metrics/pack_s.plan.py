"""Decompose, pack and re-score (`solver.path_decompose`, `temporal_pack`,
`evaluate`), seconds a plan: the self time of the "pack" spans over the
traced window, over its plans."""


def read(t):
    s = t["spans"].get("pack")
    if s is None or not t.get("plans"):
        return None
    return s / t["plans"]
