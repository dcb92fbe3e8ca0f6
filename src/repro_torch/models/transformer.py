"""The model zoo's ten architectures: the port's counterpart of
`repro.models.transformer`.  Decoder-only language models (family "lm":
dense, MoE, the Griffin hybrid and xLSTM), the encoder-decoder backbone
(family "encdec", Seamless) and the VLM backbone (family "vlm", a
projected image-embedding prefix before the text).

`Transformer` holds the layers in an `nn.ModuleList` and runs them in a
plain loop, where the reference scans over stacked block-pattern groups;
layer l has kind `block_pattern[l % len(block_pattern)]`.  An
encoder-decoder model also holds `n_enc_layers` bidirectional encoder
layers (`enc_blocks`) and `enc_ln`, and each decoder layer a
cross-attention sublayer (`ln_x`, `xattn`) onto the encoder's output.
Parameters are fp32 with the reference's shapes and scales, drawn from a
`torch.Generator` on the device (their values are not the reference's:
`convert.params_from_numpy` carries the reference's values across).

The passes mirror the reference: `train_logits` (the full-sequence
forward; under autograd it is the training path, each decoder layer
recomputed in the backward with `remat`, as the reference's
`jax.checkpoint` does; it returns the MoE load-balance loss summed over
the layers, in the graph), `init_cache`, `prefill` (last-token logits and
one cache per layer: keys and values for an attention layer, the state
and conv history for a recurrent one) and `decode_step` (one token
against the caches; attention caches are updated in place).  As in the
reference, only the decoder's causal self-attention goes through the
attention kernel at impl="kernel": the encoder's bidirectional attention
and the cross-attention run the einsum path.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from . import attention, mlp, moe, rglru, xlstm
from .common import (CastWeights, ModelConfig, init_normal, matmul, rms_norm,
                     shard, softcap, take_rows)

KINDS = ("attn", "attn_local", "rglru", "mlstm", "slstm")
FAMILIES = ("lm", "encdec", "vlm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for a block kind or family no model has."""
    other = sorted(set(cfg.block_pattern) - set(KINDS))
    if other:
        raise ValueError(f"{cfg.name}: block kinds {other} are not among "
                         f"{KINDS}")
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not among "
                         f"{FAMILIES}")


class Block(torch.nn.Module):
    """One layer, pre-norm; each sublayer's output is added to the
    residual stream.  An attention layer: attention, then, in a decoder
    layer of an encoder-decoder model (`cross`), cross-attention onto the
    encoder's output, then the MoE FFN when the config has one, else the
    MLP unless mlp_kind is "none".  A recurrent layer ("rglru"): the
    RG-LRU sublayer `rec`, then the MLP.  An xLSTM layer ("mlstm",
    "slstm"): its block `cell` alone."""

    def __init__(self, cfg: ModelConfig, kind: str, *,
                 generator: torch.Generator, device: torch.device,
                 cross: bool = False, tp: int = 1):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.kind = kind
        self.eps = cfg.rms_eps
        self.ln1 = init_normal((cfg.d_model,), zero=True, **kw)
        self.ffn = None
        if kind == "rglru":
            self.rec = rglru.RGLRU(cfg, **kw)
        elif kind == "mlstm":
            self.cell = xlstm.MLSTM(cfg, **kw)
        elif kind == "slstm":
            self.cell = xlstm.SLSTM(cfg, **kw)
        else:
            self.attn = attention.Attention(cfg, kind, tp=tp, **kw)
            if cross:
                self.ln_x = init_normal((cfg.d_model,), zero=True, **kw)
                self.xattn = attention.Attention(cfg, "attn", tp=tp, **kw)
        attn = kind in ("attn", "attn_local")
        if kind == "rglru" or (attn and (cfg.moe or cfg.mlp_kind != "none")):
            self.ln2 = init_normal((cfg.d_model,), zero=True, **kw)
            self.ffn = (moe.MoE(cfg, tp=tp, **kw) if attn and cfg.moe
                        else mlp.MLP(cfg, **kw))

    def mixer(self, h, positions, *, mode: str, cache=None,
              impl: str = "einsum", max_len: int = 0, causal: bool = True):
        """The first sublayer (attention, RG-LRU or xLSTM block) on the
        normed input: (out, new cache)."""
        if self.kind == "rglru":
            return self.rec(h, mode=mode, cache=cache, impl=impl)
        if self.kind in ("mlstm", "slstm"):
            return self.cell(h, mode=mode, cache=cache)
        if not causal:
            return self.attn.bidirectional(h, positions), None
        return self.attn(h, positions, mode=mode, cache=cache, impl=impl,
                         max_len=max_len)

    def forward(self, x, positions, *, mode: str, cache=None,
                impl: str = "einsum", max_len: int = 0, memory=None,
                causal: bool = True):
        """Returns (x, new cache, aux): aux is the MoE load-balance loss,
        0 without an MoE FFN."""
        out, new_cache = self.mixer(rms_norm(x, self.ln1, self.eps),
                                    positions, mode=mode, cache=cache,
                                    impl=impl, max_len=max_len,
                                    causal=causal)
        x = x + out
        if memory is not None and hasattr(self, "xattn"):
            x = x + self.xattn.cross(rms_norm(x, self.ln_x, self.eps),
                                     memory)
        aux = 0.0
        if isinstance(self.ffn, moe.MoE):
            out, aux = self.ffn(rms_norm(x, self.ln2, self.eps))
            x = x + out
        elif self.ffn is not None:
            x = x + self.ffn(rms_norm(x, self.ln2, self.eps))
        return x, new_cache, aux


class Transformer(CastWeights):
    """embed (vp, d) at scale 1/sqrt(d), final_ln, unembed (d, vp) when
    the embeddings are not tied, and `n_layers` Blocks; an
    encoder-decoder model also `n_enc_layers` encoder Blocks and enc_ln,
    a VLM img_proj (d, d).  The vocabulary, the attention heads and the
    MoE experts are padded for a tp-way model axis, as the reference's
    `init_params(tp=)` pads them (tp = 1 pads the vocabulary to 128)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device, tp: int = 1):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.tp = tp
        kw = dict(generator=generator, device=device)
        vp, d = cfg.padded_vocab(tp), cfg.d_model
        self.embed = init_normal((vp, d), scale=1.0 / d ** 0.5, **kw)
        self.final_ln = init_normal((d,), zero=True, **kw)
        if not cfg.tie_embeddings:
            self.unembed = init_normal((d, vp), **kw)
        cross = cfg.family == "encdec"
        self.blocks = torch.nn.ModuleList(
            Block(cfg, kind, cross=cross, tp=tp, **kw)
            for kind in cfg.pattern_for(cfg.n_layers))
        if cross:
            self.enc_blocks = torch.nn.ModuleList(
                Block(cfg, "attn", tp=tp, **kw)
                for _ in range(cfg.n_enc_layers))
            self.enc_ln = init_normal((d,), zero=True, **kw)
        if cfg.family == "vlm":
            self.img_proj = init_normal((d, d), **kw)


def _embed(model: Transformer, tokens):
    x = take_rows(model.weight("embed", torch.bfloat16), tokens)
    if model.cfg.tie_embeddings:
        # sqrt(d) in fp32, rounded to bf16 before the product
        x = x * torch.tensor(math.sqrt(model.cfg.d_model),
                             dtype=torch.float32).to(x.dtype)
    return shard(x, "batch", "seq", "embed")


def _unembed(model: Transformer, x):
    if model.cfg.tie_embeddings:
        logits = matmul(x, model.weight("embed", x.dtype).T)
    else:
        logits = matmul(x, model.weight("unembed", x.dtype))
    return shard(logits, "batch", None, "vocab")


def _inputs(model: Transformer, batch: dict):
    """The decoder's input embeddings, and the encoder's output (memory)
    for an encoder-decoder model, else None.  A VLM's image embeddings
    (B, n_img, d), projected by img_proj in bf16, come before the text."""
    x = _embed(model, batch["tokens"])
    memory = None
    if model.cfg.family == "encdec":
        memory = encode(model, batch["enc_embeds"])
    if model.cfg.family == "vlm":
        img = matmul(batch["img_embeds"].to(x.dtype),
                     model.weight("img_proj", x.dtype))
        x = torch.cat([shard(img, "batch", "seq", "embed"), x], dim=1)
    return x, memory


def _run_stack(model: Transformer, x, positions, *, mode: str, caches=None,
               impl: str = "einsum", max_len: int = 0, memory=None,
               remat: bool = False):
    """The decoder layers in order: (x, new caches or None, the summed
    aux loss (fp32)).  With `remat` and grad mode on, each layer keeps
    only its input for the backward and runs again there (the
    reference's `jax.checkpoint` with `nothing_saveable`): the same ops
    on the same inputs, so the numbers do not change."""
    new_caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and torch.is_grad_enabled()
    for i, block in enumerate(model.blocks):
        kw = dict(mode=mode, cache=None if caches is None else caches[i],
                  impl=impl, max_len=max_len, memory=memory)
        if remat:
            x, nc, aux = checkpoint(block, x, positions, use_reentrant=False,
                                    **kw)
        else:
            x, nc, aux = block(x, positions, **kw)
        new_caches.append(nc)
        aux_total = aux_total + aux
    return (x, new_caches if mode in ("prefill", "decode") else None,
            aux_total)


def encode(model: Transformer, enc_embeds):
    """The encoder over frame embeddings (B, S_enc, d): bidirectional
    attention layers on the einsum path, then enc_ln.  Returns the memory
    (B, S_enc, d) in bf16."""
    x = shard(enc_embeds.to(torch.bfloat16), "batch", "seq", "embed")
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for block in model.enc_blocks:
        x, _, _ = block(x, positions, mode="train", causal=False)
    return rms_norm(x, model.enc_ln, model.cfg.rms_eps)


def train_logits(model: Transformer, batch: dict, *, impl: str = "einsum",
                 remat: bool = True):
    """Full-sequence forward.  batch: {"tokens": (B,S) int, plus
    "enc_embeds" (B, S_enc, d) for an encoder-decoder model and
    "img_embeds" (B, n_img, d) for a VLM}.  Returns (logits (B,S,Vp) of
    the text positions, aux: the MoE load-balance loss summed over the
    layers, 0 without MoE).  `remat` recomputes each decoder layer in the
    backward (it matters only under autograd); impl="kernel" has no
    backward, and its kernels raise under autograd."""
    cfg = model.cfg
    x, memory = _inputs(model, batch)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _, aux = _run_stack(model, x, positions, mode="train", impl=impl,
                           memory=memory, remat=remat)
    x = rms_norm(x, model.final_ln, cfg.rms_eps)
    if cfg.family == "vlm":
        x = x[:, -batch["tokens"].shape[1]:]
    return softcap(_unembed(model, x), cfg.final_softcap), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: torch.device, tp: int = 1) -> list[dict]:
    """Empty caches for decode, one per decoder layer, the kv heads
    padded for a tp-way model axis."""
    def one(kind):
        if kind == "rglru":
            return rglru.make_cache(cfg, batch, device=device)
        if kind == "mlstm":
            return xlstm.make_mlstm_cache(cfg, batch, device=device)
        if kind == "slstm":
            return xlstm.make_slstm_cache(cfg, batch, device=device)
        return attention.make_cache(
            cfg, batch, max_len, "window" if kind == "attn_local" else "full",
            device=device, tp=tp)
    return [one(kind) for kind in cfg.pattern_for(cfg.n_layers)]


def prefill(model: Transformer, batch: dict, *, impl: str = "einsum",
            max_len: int = 0):
    """Prefill pass: returns (last-token logits (B,1,Vp), caches).  The
    batch is train_logits'; `max_len` counts every position a cache must
    hold, a VLM's image tokens included (0: the prefill's positions and
    one more)."""
    cfg = model.cfg
    x, memory = _inputs(model, batch)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    x, caches, _ = _run_stack(model, x, positions, mode="prefill", impl=impl,
                              max_len=max_len or S + 1, memory=memory)
    x = rms_norm(x[:, -1:], model.final_ln, cfg.rms_eps)
    return softcap(_unembed(model, x), cfg.final_softcap), caches


def decode_step(model: Transformer, caches: list, tokens, position: int, *,
                memory=None, impl: str = "einsum"):
    """One decode step.  tokens: (B, 1); position: absolute index (a
    VLM's image tokens count); memory: the encoder's output, which an
    encoder-decoder model needs.  Returns (logits (B,1,Vp), caches);
    attention caches are updated in place, a recurrent layer's cache is
    replaced."""
    cfg = model.cfg
    if cfg.family == "encdec" and memory is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder decode step "
                         f"needs the encoder's memory")
    x = _embed(model, tokens)
    positions = torch.full((1, 1), int(position), device=x.device)
    x, new_caches, _ = _run_stack(model, x, positions, mode="decode",
                                  caches=caches, impl=impl, memory=memory)
    x = rms_norm(x, model.final_ln, cfg.rms_eps)
    return softcap(_unembed(model, x), cfg.final_softcap), new_caches
