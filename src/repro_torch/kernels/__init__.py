"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions:

  pdhg_spmv - blocked-ELL layout + the plain PyTorch PDHG burst
  ops       - checked wrappers: the CUDA kernel on CUDA tensors, the plain
              version on CPU tensors, launch counters
  build     - nvcc build of kernels/csrc at first use, ctypes loading
"""
from . import build, ops, pdhg_spmv

__all__ = ["build", "ops", "pdhg_spmv"]
