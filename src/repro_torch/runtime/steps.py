"""Step factories for serving: the port's counterpart of the reference's
`runtime/steps.py::make_prefill_step` and `make_decode_step`.

Each factory returns a function of the model (the reference's params)
that runs without autograd.  `impl` is "kernel" (the counterpart of the
reference's "pallas": the prefill's causal self-attention and RG-LRU
scan go through the CUDA kernels) or "einsum" (the counterpart of
"xla").  A prefill batch is {"tokens"} plus "enc_embeds" for an
encoder-decoder model and "img_embeds" for a VLM; a decode step takes the
encoder's memory as its fifth argument, as the reference's does.  A
sharding `strategy` is not ported; the training step waits for the
training slice.
"""
from __future__ import annotations

import torch

from ..models import attention, transformer
from ..models.common import ModelConfig


def _check(cfg: ModelConfig, impl: str, strategy) -> None:
    if strategy is not None:
        raise NotImplementedError("a sharding strategy is not ported yet "
                                  "(ROADMAP.md queue 1 item 12)")
    if impl not in attention.IMPLS:
        raise ValueError(f"impl must be one of {attention.IMPLS}, got "
                         f"{impl!r}")
    transformer.check_supported(cfg)


def _same_config(cfg: ModelConfig, model: transformer.Transformer) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg.name}, model is "
                         f"{model.cfg.name}")


def make_prefill_step(cfg: ModelConfig, *, impl: str = "einsum",
                      max_len: int = 0, strategy=None):
    _check(cfg, impl, strategy)

    @torch.no_grad()
    def prefill_step(model, batch):
        _same_config(cfg, model)
        return transformer.prefill(model, batch, impl=impl, max_len=max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, impl: str = "einsum",
                     strategy=None):
    _check(cfg, impl, strategy)

    @torch.no_grad()
    def decode_step(model, caches, tokens, position, memory=None):
        _same_config(cfg, model)
        return transformer.decode_step(model, caches, tokens, position,
                                       memory=memory, impl=impl)
    return decode_step
