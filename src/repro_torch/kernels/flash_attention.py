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

`tile_plan` is the bf16 kernel's tiling for a head dim, the one copy of
it: kernels.ops passes it to the kernel's entry, which launches the
template built for it or refuses.
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
