"""The plain PyTorch version of the flash-attention kernel.

`flash_attention_plain` computes what the reference's Pallas kernel
(`repro.kernels.flash_attention._kernel`, driven by
`flash_attention_bhsd`) computes, written as one masked softmax in fp32
instead of an online softmax over kv tiles:

  s   = (q . k^T) * scale                      fp32, scale = 1/sqrt(hd)
  s   = softcap * tanh(s / softcap)            when softcap != 0
  s   = NEG_INF where masked                   causal: q_idx >= k_idx;
                                               window: q_idx - k_idx < window
  p   = exp(s - rowmax(s)),  l = rowsum(p)
  out = (p . v) / max(l, 1e-30)                cast once to q's dtype

NEG_INF is the reference's finite fill (-2.3819763e38), not -inf, so a
row whose scores are all masked gives the same finite answer as the
kernel.  GQA maps query head h to kv head h // (H / Hkv).

The CPU tests run it (kernels.ops.flash_attention on CPU tensors), and
the card holds the CUDA kernel (kernels/csrc/flash_attention.cu) against
it.  Memory is O(B * H * S * T) fp32: it is a reference, not a fast path.

`flash_attention_bf16_model` is the same function with the bf16
wgmma kernel's rounding: q.k^T of bf16 values summed in fp32, fp32 p and
l, and p . v as two bf16 products hi . v + lo . v (hi = bf16(p),
lo = bf16(p - hi)) summed in fp32, the output rounded once.  With
split=False p is rounded once to bf16 instead: the rounding the kernel
must not use, which the checks show to fail.

`flash_attention_fp32_model` is the same function as the fp32 SIMT
kernel computes it: an online softmax over the query blocks and kv tiles
of `simt_plan`, the tiles the kernel skips skipped, scores kept times
log2 e with the mask applied after the scaling (the NEG_INF fill stays
finite) and p = 2^(y - m).

`tile_plan` and `simt_plan` are the bf16 and the fp32 kernel's tilings
for a head dim, the one copy of each: kernels.ops passes the plan to the
kernel's entry, which launches the template built for it or refuses.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

NEG_INF = -2.3819763e38

# the bf16 kernel's tiling (kernels/csrc/flash_attention.cu)
SWIZZLE_BYTES = 128         # TMA's and wgmma's swizzle: one row of a box
ATOM = SWIZZLE_BYTES // 2   # bf16 columns a swizzled row holds, the N of
                            # each O += P V wgmma
CONSUMERS = 2               # consumer warpgroups a block, 64 query rows each
WGMMA_M = 64
# padded head dim -> (keys a K/V tile, tiles in the ring): the templates
# FA_WGMMA_TEMPLATES of kernels/csrc/flash_attention.cu builds
_TILES = {64: (128, 2), 128: (128, 2), 256: (64, 2)}

# the fp32 SIMT kernel's tiling (kernels/csrc/flash_attention.cu): a thread
# owns SIMT_ROWS query rows and SIMT_COLS columns of O (two float4)
SIMT_ROWS = 8
SIMT_COLS = 8
SIMT_PAD = 4                # floats past each row of p in shared memory
# padded head dim -> (query rows a block, keys a K/V tile, tiles in each
# ring): the templates FA_SIMT_TEMPLATES of kernels/csrc/flash_attention.cu
# builds
_SIMT_TILES = {32: (256, 32, 2), 64: (256, 64, 2), 128: (128, 64, 2),
               256: (64, 32, 2)}
LOG2E = 1.4426950408889634


@dataclass(frozen=True)
class TilePlan:
    """The bf16 kernel's tiling for one padded head dim."""
    hdp: int           # head dim padded in shared memory, a multiple of ATOM
    bq: int            # query rows a block (CONSUMERS x WGMMA_M)
    bkv: int           # keys a K/V tile: the N of S = Q K^T's wgmma
    stages: int        # K/V tiles in the ring
    smem: int          # shared bytes a block asks for
    box_q: tuple       # TMA box of q, innermost first: (hd, head, row, batch)
    box_kv: tuple      # the same for k and v


def tile_plan(hd: int) -> TilePlan:
    """The plan for a head dim `hd` (a multiple of 8 from 8 to 256): hd
    padded to 64, 128 or 256 (zero columns that TMA fills), BKV
    and the ring's stages from the built templates, and the shared bytes:
    Q, the K and V rings and 2 + 4 stages mbarriers of 8 bytes, after up to
    1024 bytes that align the base to the swizzle's 1024-byte repeat."""
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"tile_plan: head dim {hd} must be a multiple of 8 "
                         f"from 8 to 256")
    hdp = next(d for d in sorted(_TILES) if hd <= d)
    bkv, stages = _TILES[hdp]
    bq = CONSUMERS * WGMMA_M
    smem = (1024 + 2 * (bq * hdp + 2 * stages * bkv * hdp)
            + 8 * (2 + 4 * stages))
    return TilePlan(hdp=hdp, bq=bq, bkv=bkv, stages=stages, smem=smem,
                    box_q=(ATOM, 1, bq, 1), box_kv=(ATOM, 1, bkv, 1))


@dataclass(frozen=True)
class SimtPlan:
    """The fp32 kernel's tiling for one padded head dim."""
    hdp: int           # head dim padded in shared memory
    bq: int            # query rows a block
    bkv: int           # keys a K/V tile
    stages: int        # tiles in the K ring and in the V ring
    smem: int          # shared bytes a block asks for
    threads: int       # threads a block: SIMT_ROWS rows x SIMT_COLS
                       # columns of O each


def simt_plan(hd: int) -> SimtPlan:
    """The fp32 plan for a head dim `hd` (a multiple of 8 from 8 to
    256): hd padded to 32, 64, 128 or 256 (zero columns that the copies
    fill), the block's rows, the tile's keys and the rings' stages from the
    built templates, and the shared bytes: Q, the K and V rings, and p
    with SIMT_PAD floats past each row."""
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"simt_plan: head dim {hd} must be a multiple of 8 "
                         f"from 8 to 256")
    hdp = next(d for d in sorted(_SIMT_TILES) if hd <= d)
    bq, bkv, stages = _SIMT_TILES[hdp]
    smem = 4 * (bq * hdp + 2 * stages * bkv * hdp + bq * (bkv + SIMT_PAD))
    threads = bq // SIMT_ROWS * (hdp // SIMT_COLS)
    return SimtPlan(hdp=hdp, bq=bq, bkv=bkv, stages=stages, smem=smem,
                    threads=threads)


def kv_tiles(q0: int, q_last: int, T: int, bkv: int, causal: bool,
             window: int) -> range:
    """The kv tiles of `bkv` keys that a block of query rows [q0,
    q_last] visits: those not wholly above the causal diagonal nor wholly
    outside the window (kernels/csrc/flash_attention.cu's tile_range).  A
    skipped tile changes nothing: its weights are 0, or, before a row's
    first real score, are wiped by that score's rescale of 0."""
    j_hi = -(-T // bkv)
    if causal:
        j_hi = min(j_hi, q_last // bkv + 1)
    j_lo = 0
    first = q0 - window - bkv + 2       # tile j is in iff j * bkv >= first
    if window > 0 and first > 0:
        j_lo = -(-first // bkv)
    return range(min(j_lo, j_hi), j_hi)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, window: int, softcap: float,
                          scale: float) -> torch.Tensor:
    """q: (B,S,H,hd); k, v: (B,T,Hkv,hd) with H % Hkv == 0 -> (B,S,H,hd)
    in q's dtype.  `window` 0 means no window."""
    return _attention(q, k, v, causal=causal, window=window,
                      softcap=softcap, scale=scale, p_dot_v=_p_dot_v_fp32)


def flash_attention_bf16_model(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool, window: int,
                               softcap: float, scale: float,
                               split: bool = True) -> torch.Tensor:
    """flash_attention_plain with p . v as the bf16 kernel rounds it:
    hi . v + lo . v when `split`, else bf16(p) . v.  q, k, v are bf16."""
    return _attention(q, k, v, causal=causal, window=window,
                      softcap=softcap, scale=scale,
                      p_dot_v=_p_dot_v_split if split else _p_dot_v_once)


def flash_attention_fp32_model(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool, window: int,
                               softcap: float, scale: float) -> torch.Tensor:
    """flash_attention_plain as the fp32 kernel computes it: for each
    block of simt_plan's query rows an online softmax over the kv tiles
    that `kv_tiles` keeps, in fp32: y = s * scale * log2(e) (or
    softcap * tanh(s * scale / softcap) * log2(e)), then NEG_INF where
    masked, m the running row max of y, alpha = 2^(m_old - m_new) where
    the max moved (else 1), p = 2^(y - m), l = alpha l + sum(p), acc =
    alpha acc + p . v, out = acc / max(l, 1e-30).  q, k, v: float32
    (B,S,H,hd), (B,T,Hkv,hd) with hd a multiple of 8 -> (B,S,H,hd)."""
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    plan = simt_plan(hd)
    qg = q.float().reshape(B, S, Hkv, H // Hkv, hd)
    kf, vf = k.float(), v.float()
    out = torch.zeros_like(qg)
    for q0 in range(0, S, plan.bq):
        q1 = min(q0 + plan.bq, S)
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        m = torch.full((B, Hkv, H // Hkv, q1 - q0), NEG_INF,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(m.shape + (hd,), device=q.device)
        for j in kv_tiles(q0, q1 - 1, T, plan.bkv, causal, window):
            k0, k1 = j * plan.bkv, min((j + 1) * plan.bkv, T)
            s = torch.einsum("bskgd,btkd->bkgst", qg[:, q0:q1], kf[:, k0:k1])
            if softcap:
                y = softcap * torch.tanh(s * scale / softcap) * LOG2E
            else:
                y = s * (scale * LOG2E)
            ki = torch.arange(k0, k1, device=q.device)[None, :]
            keep = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool,
                              device=q.device)
            if causal:
                keep &= qi >= ki
            if window > 0:
                keep &= (qi - ki) < window
            y = torch.where(keep, y, torch.tensor(NEG_INF, device=q.device))
            m_new = torch.maximum(m, y.amax(dim=-1))
            alpha = torch.where(m_new != m, torch.exp2(m - m_new),
                                torch.ones_like(m))
            p = torch.exp2(y - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = (acc * alpha[..., None]
                   + torch.einsum("bkgst,btkd->bkgsd", p, vf[:, k0:k1]))
            m = m_new
        out[:, q0:q1] = (acc / torch.clamp(l, min=1e-30)[..., None]).permute(
            0, 3, 1, 2, 4)
    return out.reshape(B, S, H, hd).to(q.dtype)


def _p_dot_v_fp32(p, v):
    return torch.einsum("bkgst,btkd->bkgsd", p, v.float())


def _p_dot_v_once(p, v):
    return _p_dot_v_fp32(p.bfloat16().float(), v)


def _p_dot_v_split(p, v):
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    return _p_dot_v_fp32(hi, v) + _p_dot_v_fp32(lo, v)


def _attention(q, k, v, *, causal, window, softcap, scale, p_dot_v):
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.float().reshape(B, S, Hkv, G, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= (qi - ki) < window
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=torch.float32,
                                          device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = p_dot_v(p, v) / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)
