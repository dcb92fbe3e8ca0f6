"""Operations and bytes of one PDHG iteration of the COO burst
(kernels/csrc/pdhg_coo.cu), reckoned from an LP's size, each input read
once and each output written once: both directions' gather index and
value an entry, their offsets and output lists, the x-side vectors
(c, tau, xmax, x, keep_n, and x' written) and the y-side ones (q, sig,
y, ub, keep_m, and y' written); a multiply and an add an entry each
way plus the elementwise updates.  (The arithmetic of
`chip_smoke.py::coo_bound`, frozen here.)"""
from __future__ import annotations

F4, B1 = 4, 1


def coo_iteration_bytes(n: int, m: int, nnz: int) -> int:
    return (2 * nnz * 2 * F4 + F4 * (n + m + 2) + F4 * (n + m)
            + n * (3 * F4 + F4 + B1 + F4) + m * (2 * F4 + F4 + 2 * B1 + F4))


def coo_iteration_ops(n: int, m: int, nnz: int) -> int:
    return 4 * nnz + 7 * n + 4 * m


def coo_iteration_s(n: int, m: int, nnz: int, peaks: dict | None) -> float:
    """The least time of one iteration on a card with these peaks: the
    larger of bytes over bandwidth and operations over fp32 rate; nan
    without peaks."""
    if not peaks:
        return float("nan")
    return max(coo_iteration_bytes(n, m, nnz) / peaks["hbm_bytes_s"],
               coo_iteration_ops(n, m, nnz) / peaks["fp32_ops_s"])
