"""The problem and its horizon (`timeslot.ScheduleProblem`,
`suggest_n_slots`), seconds a plan: the self time of the "problem" spans
over the traced window, over its plans."""


def read(t):
    s = t["spans"].get("problem")
    if s is None or not t.get("plans"):
        return None
    return s / t["plans"]
