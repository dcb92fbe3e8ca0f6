"""PyTorch + CUDA port of the co-flow scheduler and its model zoo
(package `repro`).

Imports torch, numpy and scipy only — never jax and nothing of `repro`.
Three paths run on the card:

  * the scheduler, `core.solver.solve_fast`: routing-LP assembly (numpy)
    -> PDHG through the hand-written blocked-ELL burst kernel
    (kernels/csrc/pdhg_burst.cu, fp32 or bf16 iterate storage) -> path
    decomposition and slot packing -> exact re-scoring and
    certification (numpy);
  * its batched form and the sweep CLI, `core.solver.solve_fast_batch`
    and `python -m repro_torch.sweep`: instances stacked block-
    diagonally, each level one adaptive run of the same kernel
    (`kernels.ops.pdhg_adaptive`, converged instances frozen);
  * serving the dense language models, `launch.serve` (`runtime.steps`,
    `models.transformer`): prefill with attention through the
    hand-written flash-attention kernel (kernels/csrc/flash_attention.cu),
    then greedy decode against KV caches.

Device rule (`device.resolve`): entry points default to device="cuda"
and raise when no card is available; only an explicit device="cpu" runs
on the host, through the kernels' plain PyTorch versions.
"""
from . import configs, convert, core, device, kernels, models, runtime, sweep

__all__ = ["configs", "convert", "core", "device", "kernels", "models",
           "runtime", "sweep"]
