"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions:

  pdhg_spmv       - blocked-ELL layout + the plain PyTorch PDHG burst
                    (fp32 or bf16 iterate storage)
  flash_attention - the plain PyTorch version of the attention kernel
  ops             - checked wrappers: the CUDA kernel on CUDA tensors, the
                    plain version on CPU tensors, launch counters; the
                    adaptive burst driver pdhg_adaptive
  build           - nvcc build of kernels/csrc at first use, ctypes loading
"""
from . import build, flash_attention, ops, pdhg_spmv

__all__ = ["build", "flash_attention", "ops", "pdhg_spmv"]
