"""The COO burst kernel's share of its roofline, %: the least time of
the traced window's COO iterations (each plan's kernel iterations, as
counted at `ops.pdhg_coo_burst`, times the least time of one iteration
at the reference LP's size on this card's published peaks) over the
kernel's device time in the trace (`pdhg_coo_kernel`)."""
import math


def read(t):
    least = t.get("coo_least_s")
    kernel = t.get("ops", {}).get("pdhg_coo_kernel")
    if not least or kernel is None or kernel[1] <= 0 or math.isnan(least):
        return None
    return 100.0 * least / kernel[1]
