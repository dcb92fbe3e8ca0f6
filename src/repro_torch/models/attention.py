"""GQA attention: causal / sliding-window, softcap, KV caches.

The port's counterpart of `repro.models.attention`.  Three modes:
  train    full-sequence causal, no cache
  prefill  full-sequence causal, returns a cache
  decode   one new token against the cache (full or windowed ring buffer)

impl = "einsum" is the reference's "xla" math (bf16 score products,
bf16 probabilities); impl = "kernel", the counterpart of "pallas", runs
the prefill's attention through kernels.ops.flash_attention — the CUDA
kernel on the card, its plain fp32 version on the CPU.  Decode always
takes the einsum path, as in the reference.

Unlike the reference, decode writes the new key and value into the cache
tensors in place (no copy of the whole cache a step); the cache dict it
returns shares those tensors.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels import ops as kops
from .common import (CastWeights, ModelConfig, einsum, init_normal, matmul,
                     rope, shard, softcap, whole_for_split)

NEG_INF = -2.3819763e38
IMPLS = ("einsum", "kernel")


def make_cache(cfg: ModelConfig, batch: int, max_len: int, kind: str, *,
               device: torch.device, dtype=torch.bfloat16,
               tp: int = 1) -> dict:
    """KV cache for one attention layer.  kind: "full" | "window"; its kv
    heads padded for a tp-way model axis."""
    _, hkv = cfg.padded_heads(tp)
    slots = min(max_len, cfg.window) if kind == "window" else max_len
    shape = (batch, slots, hkv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "len": 0}


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """Grouped attention, the reference's einsum math.  q: (B,S,Hq,hd);
    k,v: (B,T,Hkv,hd); mask: (B|1, 1, S|1, T), True = attend."""
    if isinstance(q, DTensor):
        return _sdpa_per_rank(q, k, v, mask, cfg)
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, hd)
    # the product is rounded to q's dtype; the division (by a numpy
    # float64 scalar in the reference) promotes to float32
    scores = einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(hd)
    scores = softcap(scores, cfg.attn_softcap)
    scores = torch.where(mask[:, :, None], scores, NEG_INF)
    # the max is a constant of the softmax's gradient, as in jax.nn.softmax
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True).detach())
    probs = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    out = einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, Hq, hd)


def _sdpa_per_rank(q, k, v, mask, cfg: ModelConfig):
    """_sdpa of DTensors on each rank's batch rows and heads, as the
    reference's shard_map of a head-parallel attention: q, k and v are
    laid out alike, split over batch (dim 0) and heads (dim 2) where both
    head counts divide, whole elsewhere, and the result is laid out as
    q.  (DTensor's own einsum flattens the batch and head dims, and
    cannot unflatten them when a split dim sits behind a whole one.)
    Every mask of this module is the same for all batch rows."""
    mesh = q.device_mesh
    pl = []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        keep = (isinstance(p, Shard) and n > 1
                and (p.dim == 0 and q.shape[0] % n == 0
                     or p.dim == 2 and q.shape[2] % n == 0
                     and k.shape[2] % n == 0))
        pl.append(p if keep else Replicate())
    q, k, v = (t.redistribute(mesh, tuple(pl)) for t in (q, k, v))
    if isinstance(mask, DTensor):
        mask = mask.full_tensor()
    out = _sdpa(q.to_local(), k.to_local(), v.to_local(), mask[:1], cfg)
    return DTensor.from_local(out, mesh, tuple(pl), run_check=False)


def _flash(q, k, v, cfg: ModelConfig, *, causal: bool, window: int | None):
    return kops.flash_attention(q, k, v, causal=causal, window=window,
                                softcap=cfg.attn_softcap)


def _causal_mask(q_pos, t_pos, cfg: ModelConfig, local: bool):
    mask = q_pos[:, None] >= t_pos[None, :]
    if local:
        mask &= q_pos[:, None] - t_pos[None, :] < cfg.window
    return mask[None, None]


def _sdpa_chunked(q, k, v, cfg: ModelConfig, *, local: bool):
    """Query-chunked causal attention: scores never exceed
    (B, Hkv, G, cq, T) — the einsum path's answer to long sequences."""
    S = q.shape[1]
    T = k.shape[1]
    cq = max(128, min(S, (1 << 22) // max(T, 1)))
    while S % cq:
        cq //= 2
    cq = max(cq, 1)
    t_pos = torch.arange(T, device=q.device)
    outs = []
    for c0 in range(0, S, cq):
        q_pos = c0 + torch.arange(cq, device=q.device)
        outs.append(_sdpa(q[:, c0:c0 + cq], k, v,
                          _causal_mask(q_pos, t_pos, cfg, local), cfg))
    return torch.cat(outs, dim=1)


def _fill_cache(cfg: ModelConfig, k, v, local: bool, max_len: int) -> dict:
    """A cache from prefill keys/values sized for decoding up to max_len
    total positions (window slots for local layers)."""
    B, S = k.shape[:2]
    if local:
        slots = min(max_len, cfg.window)
        if S > slots:
            # keep the last `slots` keys, rotated so that absolute
            # position p sits at ring slot p % slots
            shift = S % slots
            k = torch.roll(k[:, -slots:], shift, dims=1)
            v = torch.roll(v[:, -slots:], shift, dims=1)
            pad = 0
        else:
            pad = slots - S
    else:
        pad = max(max_len - S, 0)

    def padded(x):
        x = x.to(torch.bfloat16)
        if not pad:
            return x.contiguous()
        return torch.cat([x, x.new_zeros((B, pad) + x.shape[2:])], dim=1)

    return {"k": padded(k), "v": padded(v), "len": S}


def _append_cache(cache: dict, k, v, local: bool):
    """Write one token into the cache in place; return (cache', keys,
    vals, valid)."""
    B = k.shape[0]
    ck, cv = cache["k"], cache["v"]
    slots = ck.shape[1]
    length = cache["len"]
    idx = length % slots if local else min(length, slots - 1)
    ck[:, idx] = k[:, 0].to(ck.dtype)
    cv[:, idx] = v[:, 0].to(cv.dtype)
    new_len = length + 1
    valid = (torch.arange(slots, device=k.device) < new_len)[None, :]
    valid = valid.expand(B, slots)
    return ({"k": ck, "v": cv, "len": new_len}, ck.to(k.dtype),
            cv.to(v.dtype), valid)


class Attention(CastWeights):
    """One attention layer: wq (d, hq, hd), wk and wv (d, hkv, hd), wo
    (hq, hd, d), fp32, read in the activation's dtype, the head counts
    padded for a tp-way model axis (ModelConfig.padded_heads).  kind:
    "attn" | "attn_local"."""

    def __init__(self, cfg: ModelConfig, kind: str, *,
                 generator: torch.Generator, device: torch.device,
                 tp: int = 1):
        super().__init__()
        if kind not in ("attn", "attn_local"):
            raise ValueError(f"attention kind {kind!r}")
        self.cfg, self.kind = cfg, kind
        d, hd = cfg.d_model, cfg.hd
        hq, hkv = cfg.padded_heads(tp)
        kw = dict(generator=generator, device=device)
        self.wq = init_normal((d, hq, hd), **kw)
        self.wk = init_normal((d, hkv, hd), **kw)
        self.wv = init_normal((d, hkv, hd), **kw)
        self.wo = init_normal((hq, hd, d), **kw)

    def _proj(self, name, x):
        """x (B, S, d) through w (d, heads, hd) -> (B, S, heads, hd)."""
        B, S, d = x.shape
        w = self.weight(name, x.dtype)
        out = whole_for_split(matmul(x, w.reshape(d, -1)), 2, w.shape[1])
        return out.view(B, S, w.shape[1], w.shape[2])

    def _qkv(self, x, positions):
        theta = self.cfg.rope_theta
        q = rope(self._proj("wq", x), positions, theta)
        k = rope(self._proj("wk", x), positions, theta)
        q = shard(q, "batch", None, "heads", None)
        k = shard(k, "batch", None, "kv_heads", None)
        v = shard(self._proj("wv", x), "batch", None, "kv_heads", None)
        return q, k, v

    def _out(self, out):
        """Attention output (B, S, hq, hd) through wo -> (B, S, d)."""
        B, S = out.shape[:2]
        wo = self.weight("wo", out.dtype)
        return matmul(out.reshape(B, S, -1), wo.reshape(-1, wo.shape[2]))

    def bidirectional(self, x, positions):
        """The encoder's attention (the reference's
        `transformer._bidir_attention`): RoPE'd q and k, every position
        attending to every other, on the einsum path for every impl."""
        q, k, v = self._qkv(x, positions)
        S = x.shape[1]
        mask = torch.ones((1, 1, S, S), dtype=torch.bool, device=x.device)
        return shard(self._out(_sdpa(q, k, v, mask, self.cfg)),
                     "batch", "seq", "embed")

    def cross(self, x, memory):
        """Cross-attention of x (B, S, d) onto memory (B, T, d) (the
        reference's `transformer._cross_attention`): no RoPE and no
        cache, so memory's keys and values are recomputed every call;
        every query attends to every memory position, on the einsum
        path."""
        q = self._proj("wq", x)
        k, v = self._proj("wk", memory), self._proj("wv", memory)
        mask = torch.ones((1, 1, x.shape[1], memory.shape[1]),
                          dtype=torch.bool, device=x.device)
        return shard(self._out(_sdpa(q, k, v, mask, self.cfg)),
                     "batch", "seq", "embed")

    def forward(self, x, positions, *, mode: str, cache: dict | None = None,
                impl: str = "einsum", max_len: int = 0):
        """Attention layer body.  Returns (out (B,S,D), new cache or
        None)."""
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        cfg = self.cfg
        S = x.shape[1]
        q, k, v = self._qkv(x, positions)
        local = self.kind == "attn_local"
        new_cache = None

        if mode in ("train", "prefill"):
            if impl == "kernel" and S > 1:
                out = _flash(q, k, v, cfg, causal=True,
                             window=cfg.window if local else None)
            elif S > 2048:
                out = _sdpa_chunked(q, k, v, cfg, local=local)
            else:
                t = torch.arange(S, device=x.device)
                out = _sdpa(q, k, v, _causal_mask(t, t, cfg, local), cfg)
            if mode == "prefill":
                new_cache = _fill_cache(cfg, k, v, local, max_len or S)
        elif mode == "decode":
            if S != 1 or cache is None:
                raise ValueError("decode takes one token and a cache")
            new_cache, keys, vals, valid = _append_cache(cache, k, v, local)
            out = _sdpa(q, keys, vals, valid[:, None, None, :], cfg)
        else:
            raise ValueError(mode)

        return shard(self._out(out), "batch", "seq", "embed"), new_cache
