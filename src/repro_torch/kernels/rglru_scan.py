"""The plain PyTorch version of the RG-LRU scan kernel.

`rglru_scan_plain` computes what the reference's Pallas kernel
(`repro.kernels.rglru_scan._kernel`, driven by `rglru_scan`) computes:
the linear recurrence

  h_t = a_t * h_{t-1} + b_t        elementwise over (B, R), t = 0 .. S-1

from h_{-1} = h0 (zeros by default), returning every h_t and the last.
It walks S in order, as the TPU kernel's fori_loop does, in fp32 with the
product and the sum each rounded (two separate tensor ops, never a fused
multiply-add), so the CUDA kernel (kernels/csrc/rglru_scan.cu, built
with -fmad=false) gives the same bits.  Any R is allowed.

The CPU tests run it (kernels.ops.rglru on CPU tensors), and the card
holds the CUDA kernel against it.  It is S launches of small ops on the
card: a reference, not a fast path.
"""
from __future__ import annotations

import torch


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor,
                     h0: torch.Tensor | None = None):
    """a, b: (B, S, R) float32; h0: (B, R) or None (zeros).  Returns
    (h (B, S, R), h_last (B, R))."""
    B, S, R = a.shape
    h = (torch.zeros((B, R), dtype=a.dtype, device=a.device) if h0 is None
         else h0)
    out = torch.empty_like(a)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, h.clone()
