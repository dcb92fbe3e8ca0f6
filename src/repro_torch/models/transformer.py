"""Decoder-only language models: the port's counterpart of
`repro.models.transformer`, for family "lm" with attention layers
("attn", "attn_local") and Griffin recurrent layers ("rglru"), no MoE,
and any of the MLP kinds.

`Transformer` holds the layers in an `nn.ModuleList` and runs them in a
plain loop, where the reference scans over stacked block-pattern groups;
layer l has kind `block_pattern[l % len(block_pattern)]`.  Parameters are
fp32 with the reference's shapes and scales, drawn from a
`torch.Generator` on the device (their values are not the reference's:
`convert.params_from_numpy` carries the reference's values across).

The passes mirror the reference: `train_logits` (the forward only; the
tests' teacher-forced reference), `init_cache`, `prefill` (last-token
logits and one cache per layer: keys and values for an attention layer,
the RG-LRU state and conv history for a recurrent one) and `decode_step`
(one token against the caches; attention caches are updated in place).
"""
from __future__ import annotations

import math

import torch

from . import attention, mlp, rglru
from .common import (CastWeights, ModelConfig, init_normal, matmul, rms_norm,
                     softcap)

KINDS = ("attn", "attn_local", "rglru")
# where the rest of the model zoo stands in the port
UNPORTED = ("not ported yet: ROADMAP.md queue 1 item 11 (the workload "
            "side) lists MoE, xLSTM, encoder-decoder and VLM models as "
            "still to port")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config the port cannot run yet."""
    if cfg.family != "lm":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is "
                                  f"{UNPORTED}")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE layers are {UNPORTED}")
    other = sorted(set(cfg.block_pattern) - set(KINDS))
    if other:
        raise NotImplementedError(f"{cfg.name}: block kinds {other} are "
                                  f"{UNPORTED}")


class Block(torch.nn.Module):
    """One layer, pre-norm.  An attention layer: attention, then (unless
    mlp_kind is "none") an MLP.  A recurrent layer ("rglru"): the RG-LRU
    sublayer `rec`, then the MLP.  Each sublayer's output is added to
    the residual stream."""

    def __init__(self, cfg: ModelConfig, kind: str, *,
                 generator: torch.Generator, device: torch.device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.kind = kind
        self.eps = cfg.rms_eps
        self.ln1 = init_normal((cfg.d_model,), zero=True, **kw)
        if kind == "rglru":
            self.rec = rglru.RGLRU(cfg, **kw)
        else:
            self.attn = attention.Attention(cfg, kind, **kw)
        self.ffn = None
        if kind == "rglru" or cfg.mlp_kind != "none":
            self.ln2 = init_normal((cfg.d_model,), zero=True, **kw)
            self.ffn = mlp.MLP(cfg, **kw)

    def mixer(self, h, positions, *, mode: str, cache=None,
              impl: str = "einsum", max_len: int = 0):
        """The first sublayer (attention or RG-LRU) on the normed input:
        (out, new cache)."""
        if self.kind == "rglru":
            return self.rec(h, mode=mode, cache=cache, impl=impl)
        return self.attn(h, positions, mode=mode, cache=cache, impl=impl,
                         max_len=max_len)

    def forward(self, x, positions, *, mode: str, cache=None,
                impl: str = "einsum", max_len: int = 0):
        out, new_cache = self.mixer(rms_norm(x, self.ln1, self.eps),
                                    positions, mode=mode, cache=cache,
                                    impl=impl, max_len=max_len)
        x = x + out
        if self.ffn is not None:
            x = x + self.ffn(rms_norm(x, self.ln2, self.eps))
        return x, new_cache


class Transformer(CastWeights):
    """embed (vp, d) at scale 1/sqrt(d), final_ln, unembed (d, vp) when
    the embeddings are not tied, and `n_layers` Blocks."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        vp, d = cfg.padded_vocab(1), cfg.d_model
        self.embed = init_normal((vp, d), scale=1.0 / d ** 0.5, **kw)
        self.final_ln = init_normal((d,), zero=True, **kw)
        if not cfg.tie_embeddings:
            self.unembed = init_normal((d, vp), **kw)
        self.blocks = torch.nn.ModuleList(
            Block(cfg, kind, **kw) for kind in cfg.pattern_for(cfg.n_layers))


def _embed(model: Transformer, tokens):
    x = model.weight("embed", torch.bfloat16)[tokens]
    if model.cfg.tie_embeddings:
        # sqrt(d) in fp32, rounded to bf16 before the product
        x = x * torch.tensor(math.sqrt(model.cfg.d_model),
                             dtype=torch.float32).to(x.dtype)
    return x


def _unembed(model: Transformer, x):
    if model.cfg.tie_embeddings:
        return matmul(x, model.weight("embed", x.dtype).T)
    return matmul(x, model.weight("unembed", x.dtype))


def _run_stack(model: Transformer, x, positions, *, mode: str, caches=None,
               impl: str = "einsum", max_len: int = 0):
    new_caches = []
    for i, block in enumerate(model.blocks):
        x, nc = block(x, positions, mode=mode,
                      cache=None if caches is None else caches[i],
                      impl=impl, max_len=max_len)
        new_caches.append(nc)
    return x, (new_caches if mode in ("prefill", "decode") else None)


def train_logits(model: Transformer, batch: dict, *, impl: str = "einsum"):
    """Full-sequence forward.  batch: {"tokens": (B,S) int}.  Returns
    (logits (B,S,Vp), aux), aux 0 (no MoE)."""
    cfg = model.cfg
    x = _embed(model, batch["tokens"])
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _ = _run_stack(model, x, positions, mode="train", impl=impl)
    x = rms_norm(x, model.final_ln, cfg.rms_eps)
    return softcap(_unembed(model, x), cfg.final_softcap), 0.0


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: torch.device) -> list[dict]:
    """Empty caches for decode, one per layer."""
    def one(kind):
        if kind == "rglru":
            return rglru.make_cache(cfg, batch, device=device)
        return attention.make_cache(
            cfg, batch, max_len, "window" if kind == "attn_local" else "full",
            device=device)
    return [one(kind) for kind in cfg.pattern_for(cfg.n_layers)]


def prefill(model: Transformer, batch: dict, *, impl: str = "einsum",
            max_len: int = 0):
    """Prefill pass: returns (last-token logits (B,1,Vp), caches)."""
    cfg = model.cfg
    x = _embed(model, batch["tokens"])
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    x, caches = _run_stack(model, x, positions, mode="prefill", impl=impl,
                           max_len=max_len or S + 1)
    x = rms_norm(x[:, -1:], model.final_ln, cfg.rms_eps)
    return softcap(_unembed(model, x), cfg.final_softcap), caches


def decode_step(model: Transformer, caches: list, tokens, position: int, *,
                impl: str = "einsum"):
    """One decode step.  tokens: (B, 1); position: absolute index.
    Returns (logits (B,1,Vp), caches); attention caches are updated in
    place, a recurrent layer's cache is replaced."""
    cfg = model.cfg
    x = _embed(model, tokens)
    positions = torch.full((1, 1), int(position), device=x.device)
    x, new_caches = _run_stack(model, x, positions, mode="decode",
                               caches=caches, impl=impl)
    x = rms_norm(x, model.final_ln, cfg.rms_eps)
    return softcap(_unembed(model, x), cfg.final_softcap), new_caches
