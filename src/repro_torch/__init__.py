"""PyTorch + CUDA port of the co-flow scheduler (package `repro`).

Imports torch and numpy only — never jax and nothing of `repro`.  The
main path is `core.solver.solve_fast`: routing-LP assembly (numpy) ->
PDHG on the card through the hand-written blocked-ELL burst kernel
(kernels/csrc/pdhg_burst.cu) -> path decomposition and slot packing ->
exact re-scoring and certification (numpy).

Device rule (`device.resolve`): entry points default to device="cuda"
and raise when no card is available; only an explicit device="cpu" runs
on the host, through the kernel's plain PyTorch version.
"""
from . import convert, core, device, kernels

__all__ = ["convert", "core", "device", "kernels"]
