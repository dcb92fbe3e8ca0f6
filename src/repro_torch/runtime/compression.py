"""Gradient compression for data-parallel reduces: per-row symmetric int8
with error feedback.  The port's counterpart of
`repro.runtime.compression`, bitwise the reference's on the same fp32
input.

Error feedback keeps the quantization noise from accumulating across
steps:
    q_t = Q(g_t + e_t);  e_{t+1} = (g_t + e_t) - dequant(q_t)
so the dequantized payloads plus the last error sum to the true
gradients.  A row is the last axis; `torch.round` rounds half to even,
as `jnp.round` does, and 127 divides as an fp32 tensor (CUDA's division
by a Python scalar multiplies by its reciprocal instead).  Trees are
plain dicts, lists and tuples of tensors (`repro_torch.tree`).
"""
from __future__ import annotations

from typing import Any

import torch

from .. import tree as ptree

PyTree = Any


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8.  Returns (q int8, scale fp32 (..., 1))."""
    gf = g.float()
    amax = torch.amax(torch.abs(gf), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error(params: PyTree) -> PyTree:
    return ptree.map_with_path(
        lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device), params)


def compress_grads(grads: PyTree, error: PyTree):
    """Returns (the quantized payload tree, a {"q", "scale"} dict a leaf;
    the new error feedback tree)."""
    new_err = {}

    def one(path, g, e):
        corrected = g.float() + e
        q, s = quantize(corrected)
        new_err[path] = corrected - dequantize(q, s)
        return {"q": q, "scale": s}
    payload = ptree.map_with_path(one, grads, error)
    return payload, ptree.map_with_path(lambda path, _: new_err[path], grads)


def decompress_grads(payload: PyTree) -> PyTree:
    return ptree.map_with_path(
        lambda _, p: dequantize(p["q"], p["scale"]), payload,
        is_leaf=lambda x: isinstance(x, dict) and "q" in x)


def compressed_bytes(payload: PyTree) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in ptree.flatten(payload))
