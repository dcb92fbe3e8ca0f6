"""The certificate (`verify.check_schedule`), seconds a plan: the self time
of the "cert" spans over the traced window, over its plans."""


def read(t):
    s = t["spans"].get("cert")
    if s is None or not t.get("plans"):
        return None
    return s / t["plans"]
