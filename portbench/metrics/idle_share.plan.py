"""The device's idle share of the traced window, %: one less the union
of the device's activity intervals (CUPTI) over the window's wall time."""


def read(t):
    busy, window = t.get("busy_s"), t.get("window_s")
    if not busy or not window:
        return None
    return 100.0 * (1.0 - busy / window)
