"""Feed-forward blocks: SwiGLU (llama family), squared ReLU (nemotron),
GeGLU (gemma family) and GELU, with the tanh-approximate GELU.

Sigmoid, SiLU and GELU are written out op by op, each op rounded to the
activation's dtype, with the constants rounded to it first: that is how
the reference's `jax.nn.sigmoid` (1 / (1 + exp(-x))), `jax.nn.silu`
(x * sigmoid(x)) and `jax.nn.gelu(approximate=True)` evaluate in bf16,
and a fused `torch.sigmoid` / `F.silu` / `F.gelu`, which rounds once,
differs from them in the last bf16 place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import CastWeights, ModelConfig, init_normal, matmul, shard

KINDS = ("swiglu", "geglu", "relu2", "gelu")


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1 / (torch.exp(-x) + 1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    def c(value):   # the constant rounded to x's dtype, as a Python float
        return torch.tensor(value, dtype=x.dtype).item()
    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * ((torch.tanh(inner) + 1) * 0.5)


class MLP(CastWeights):
    """w_up (d, f) and w_down (f, d), plus w_gate (d, f) for the gated
    kinds; fp32, read in the activation's dtype."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        if cfg.mlp_kind not in KINDS:
            raise ValueError(f"mlp_kind {cfg.mlp_kind!r} is not one of "
                             f"{KINDS}")
        self.kind = cfg.mlp_kind
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(generator=generator, device=device)
        self.w_up = init_normal((d, f), **kw)
        self.w_down = init_normal((f, d), **kw)
        if self.kind in ("swiglu", "geglu"):
            self.w_gate = init_normal((d, f), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Under a strategy every activation operand of the three products
        # is laid out by its logical axes, and so is its gradient (see
        # `shard`), as the reference's constraints lay out both: under
        # "fsdp" the tokens split over every rank, so each product and
        # each weight gradient's sum over tokens is split over "model".
        # Left to DTensor's propagation, the gate's gradient came back
        # whole on "model", and torch 2.11 then multiplied a data row's
        # sequences by the whole weight on every rank of the row (16x a
        # rank's flops at 16 x 16).
        dt = x.dtype
        up = shard(matmul(x, self.weight("w_up", dt)), "batch", None, "mlp")
        if self.kind in ("swiglu", "geglu"):
            gate = shard(matmul(x, self.weight("w_gate", dt)),
                         "batch", None, "mlp")
            act = silu if self.kind == "swiglu" else gelu_tanh
            h = act(gate) * up
        elif self.kind == "relu2":
            h = torch.square(F.relu(up))
        else:
            h = gelu_tanh(up)
        h = shard(h, "batch", None, "mlp")
        return shard(matmul(h, self.weight("w_down", dt)),
                     "batch", "seq", "embed")
