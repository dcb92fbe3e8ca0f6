"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions:

  pdhg_coo        - the COO plan + the plain PyTorch PDHG burst in the
                    reference's COO summation order (backend="xla", the
                    default lowering, as in the reference)
  pdhg_spmv       - blocked-ELL layout + the plain PyTorch PDHG burst
                    (fp32 or bf16 iterate storage; backend="pallas")
  flash_attention - the plain PyTorch version of the attention kernel
  ops             - checked wrappers: the CUDA kernel on CUDA tensors, the
                    plain version on CPU tensors, launch counters; the
                    adaptive burst drivers pdhg_adaptive and
                    pdhg_coo_adaptive
  build           - nvcc build of kernels/csrc at first use, ctypes loading
"""
from . import build, flash_attention, ops, pdhg_coo, pdhg_spmv

__all__ = ["build", "flash_attention", "ops", "pdhg_coo", "pdhg_spmv"]
