"""Config schema, parameter initialisation, and shared layer primitives.

The port's counterpart of `repro.models.common`: `MoEConfig` and
`ModelConfig` (copied as they are, so every config file reads the same),
`rms_norm`, `softcap` and `rope` on torch tensors, `init_normal` for the
parameter draws, `CastWeights` (fp32 masters read in the activation's
dtype), `matmul`/`einsum` with one rounding, and the training loss
`cross_entropy`, and the activation-sharding hook: `shard(x, *axes)`
names x's logical axes, and does nothing until `runtime.sharding`
installs a sharder with `set_sharder`, as in the reference (the port's
sharder redistributes a DTensor activation to the strategy's layout).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0            # qwen2-moe: one shared expert (gated)
    d_shared: int = 0
    capacity_factor: float = 1.25
    group_size: int = 1024       # tokens per dispatch group


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # block pattern, repeated to cover n_layers.  kinds:
    #   "attn"       full causal attention + MLP
    #   "attn_local" sliding-window attention + MLP
    #   "rglru"      Griffin recurrent block + MLP
    #   "mlstm"      xLSTM matrix-memory block (no separate MLP)
    #   "slstm"      xLSTM scalar-memory block (no separate MLP)
    block_pattern: tuple[str, ...] = ("attn",)
    mlp_kind: str = "swiglu"     # swiglu | relu2 | geglu | none
    moe: MoEConfig | None = None
    window: int = 4096           # sliding-window size for attn_local
    attn_softcap: float = 0.0    # gemma2: 50.0
    final_softcap: float = 0.0   # gemma2: 30.0
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    family: str = "lm"           # lm | encdec | vlm
    n_enc_layers: int = 0        # encdec: encoder depth
    n_img_tokens: int = 0        # vlm: stub patch-embedding tokens
    rms_eps: float = 1e-6
    # sharding strategy hint (the reference's runtime.sharding reads it)
    sharding: str = "2d"         # "2d" (FSDP x TP + SP) | "fsdp" (ZeRO-3)
    # sub-quadratic? (drives long_500k eligibility in the reference)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def pattern_for(self, n_layers: int) -> tuple[str, ...]:
        reps = math.ceil(n_layers / len(self.block_pattern))
        return (self.block_pattern * reps)[:n_layers]

    def padded_heads(self, tp: int) -> tuple[int, int]:
        """(n_q_heads, n_kv_heads) padded for a tp-way model axis.

        Zero-weight padding heads keep semantics."""
        if self.sharding == "fsdp" or tp == 1:
            return self.n_heads, self.n_kv_heads
        hq = math.ceil(self.n_heads / tp) * tp
        hkv = self.n_kv_heads if self.n_kv_heads % tp == 0 \
            else math.ceil(self.n_kv_heads / tp) * tp
        assert hq % hkv == 0 or hkv % hq == 0
        return hq, min(hkv, hq)

    def padded_vocab(self, tp: int) -> int:
        mult = 128 * max(tp, 1)
        return math.ceil(self.vocab_size / mult) * mult


def init_normal(shape: tuple[int, ...], *, generator: torch.Generator,
                device: torch.device, scale: float | None = None,
                zero: bool = False) -> torch.nn.Parameter:
    """One fp32 parameter, drawn as the reference's ParamFactory.tensor
    draws it: zeros, or N(0, 1) * scale with scale = 1/sqrt(fan_in) and
    fan_in = shape[-2] (shape[-1] for a vector).  The values come from
    `generator` on `device`, so they are not the reference's values."""
    if zero:
        t = torch.zeros(shape, dtype=torch.float32, device=device)
    else:
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        t = torch.empty(shape, dtype=torch.float32, device=device)
        t.normal_(generator=generator).mul_(scale)
    return torch.nn.Parameter(t, requires_grad=False)


class CastWeights(torch.nn.Module):
    """A module whose weights are held in fp32 and read in the
    activation's dtype, as every reference use `w.astype(x.dtype)` does.

    `weight(name, dtype)` keeps one cast copy per weight and refreshes it
    when the weight changes (a new storage or an in-place write such as
    `load_state_dict` or an optimizer step), so serving reads bf16
    weights without casting the fp32 ones on every step.  While grad
    mode is on and the weight requires grad, it returns a fresh cast in
    the graph instead: that cast's gradient is taken in its dtype and
    cast back to fp32 for the master, as `jax.grad` of `astype` does, and
    two reads of one weight are two casts whose fp32 gradients add."""

    def __init__(self):
        super().__init__()
        self._casts: dict[str, tuple[tuple, torch.Tensor]] = {}
        # name -> the model's own parameter, while a copy gathered from it
        # stands in its place (runtime.steps._gathered)
        self._sources: dict[str, torch.Tensor] = {}

    def weight(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        w = getattr(self, name)
        if w.dtype == dtype:
            return w
        if w.requires_grad and torch.is_grad_enabled():
            return w.to(dtype)
        # the cast keys on the model's own parameter, not on a gathered
        # copy, whose storage the next step's gather may get again.  A
        # DTensor keys on its local shard's storage and on its own
        # version: an in-place op on a DTensor counts there, not on the
        # local shard's
        src = self._sources.get(name, w)
        local = src.to_local() if isinstance(src, DTensor) else src
        key = (dtype, local.data_ptr(), local._version, src._version)
        hit = self._casts.get(name)
        if hit is None or hit[0] != key:
            hit = (key, w.detach().to(dtype))
            self._casts[name] = hit
        return hit[1]


# activation-sharding hook: runtime.sharding installs the real layout
# function; models stay import-independent of the mesh machinery.
_SHARDER: Callable[[torch.Tensor, tuple], torch.Tensor] | None = None


def set_sharder(fn: Callable[[torch.Tensor, tuple], torch.Tensor] | None
                ) -> None:
    global _SHARDER
    _SHARDER = fn


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Annotate activation x with logical axes (x itself without a
    sharder).  The gradient that reaches the result in the backward is
    laid out by the same axes before it goes on to x, as the transpose of
    the reference's sharding constraint constrains the cotangent."""
    if _SHARDER is None:
        return x
    return _SHARDER(x, axes)


def whole_partials(x: torch.Tensor) -> torch.Tensor:
    """x with a DTensor's partial sums reduced (Replicate on those mesh
    dims); anything else as it is."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        return x.redistribute(x.device_mesh, tuple(
            Replicate() if p.is_partial() else p for p in x.placements))
    return x


def take_rows(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """w[idx]: rows of a (V, D) table.  A DTensor table is read on each
    rank from its own shard (DTensor's row-lookup rules fail in some
    torch releases): the indices are made whole on the mesh dims that
    split the table; where V is split, each rank takes the rows in its
    range and zeros elsewhere, and the result is the ranks' partial sum
    (one non-zero term a row, so exact); where D is split, the rows stay
    split on it."""
    if not isinstance(w, DTensor):
        return w[idx]
    mesh = w.device_mesh
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, (Replicate(),) * mesh.ndim,
                                 run_check=False)
    idx_pl, out_pl, grad_pl = [], [], []
    rows, first = w.shape[0], 0
    for i, p in enumerate(w.placements):
        q = idx.placements[i]
        if isinstance(p, Shard) and mesh.size(i) > 1:
            idx_pl.append(Replicate())
            grad_pl.append(p)
            if p.dim == 0:
                rows //= mesh.size(i)
                first += mesh.get_local_rank(i) * rows
                out_pl.append(Partial())
            else:
                out_pl.append(Shard(idx.dim()))
        else:
            split = isinstance(q, Shard)
            idx_pl.append(q if split else Replicate())
            out_pl.append(q if split else Replicate())
            # a whole table read by rank-split indices: each rank's
            # gradient is its rows' part of the sum
            grad_pl.append(Partial() if split else p)
    local = idx.redistribute(mesh, tuple(idx_pl)).to_local()
    table = w.to_local(grad_placements=tuple(grad_pl))
    if rows == w.shape[0]:
        out = table[local]
    else:
        mine = (local >= first) & (local < first + rows)
        out = torch.where(mine[..., None],
                          table[(local - first).clamp(0, rows - 1)], 0)
    return DTensor.from_local(out, mesh, tuple(out_pl), run_check=False)


def whole_for_split(x: torch.Tensor, dim: int, lead: int) -> torch.Tensor:
    """x about to have dim `dim` split into (lead, rest): a DTensor whose
    `dim` is split over ranks that `lead` does not divide gets that dim
    whole first (DTensor splits a sharded dim only when the leading
    factor keeps the shards); anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    split = [i for i, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim == dim]
    if lead % math.prod(x.device_mesh.size(i) for i in split) == 0:
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if i in split else p
        for i, p in enumerate(x.placements)))


def local_elementwise(fn: Callable[[torch.Tensor], torch.Tensor],
                      x: torch.Tensor) -> torch.Tensor:
    """fn(x) for an elementwise fn; on a DTensor, fn of each rank's shard
    (a partial sum made whole first), laid out as x.  For elementwise ops
    that DTensor has no sharding rule for, forward or backward: autograd
    runs fn's backward on the shards too."""
    if not isinstance(x, DTensor):
        return fn(x)
    x = whole_partials(x)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _splits_sum(operands: tuple, summed: tuple) -> bool:
    """Whether a DTensor operand splits one of its summed dims (`summed`:
    a set of dims an operand) over a mesh dim of more than one rank: its
    product would be partial sums a rank."""
    for t, dims in zip(operands, summed):
        if not isinstance(t, DTensor):
            continue
        for i, p in enumerate(t.placements):
            if (t.device_mesh.size(i) > 1 and isinstance(p, Shard)
                    and p.dim % t.dim() in dims):
                return True
    return False


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in a's dtype, accumulated in fp32 and rounded once.

    cuBLAS does that for bf16 on the card when PyTorch's
    `allow_bf16_reduced_precision_reduction` is off (the serve CLI turns
    it off; with it on, a split-K product may sum its partial results in
    bf16, a place or more off).  PyTorch's bf16 matmul on the
    CPU can round partial sums, which moves the last bf16 place, so on
    the CPU the product is taken in fp32 and rounded once: that is also
    what the reference's bf16 dots compute on the CPU.  So is a product
    of DTensors that split the summed dim over ranks, on either device:
    the ranks' fp32 partial sums are added before the one rounding (a
    bf16 product would round each rank's part and then their sum)."""
    if a.dtype != torch.float32 and (
            a.device.type == "cpu"
            or _splits_sum((a, b), ({a.dim() - 1}, {b.dim() - 2}))):
        return whole_partials(a.float() @ b.float()).to(a.dtype)
    return a @ b


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.einsum of two operands with `matmul`'s rounding."""
    if a.dtype != torch.float32:
        ins, out = eq.replace(" ", "").split("->")
        sa, sb = ins.split(",")
        if a.device.type == "cpu" or _splits_sum(
                (a, b), ({i for i, c in enumerate(sa) if c not in out},
                         {i for i, c in enumerate(sb) if c not in out})):
            return whole_partials(
                torch.einsum(eq, a.float(), b.float())).to(a.dtype)
    return torch.einsum(eq, a, b)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    freqs = torch.pow(theta, exponent)
    angles = positions[..., None].float() * freqs       # (..., S, hd/2)
    angles = angles[..., None, :]                       # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  n_real_vocab: int, final_cap: float = 0.0) -> torch.Tensor:
    """Mean CE over tokens, in fp32: `final_cap` softcap first, the padded
    vocabulary entries (index >= n_real_vocab) filled with -1e30, the
    logsumexp, and the mean of the tokens whose label is not -1 (a VLM's
    image positions, say) over max(count, 1)."""
    logits = softcap(logits.float(), final_cap)
    pad = torch.arange(logits.shape[-1], device=logits.device) >= n_real_vocab
    logits = torch.where(pad, -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels >= 0
    safe = labels.clamp_min(0).long()
    # gathered from (tokens, vocab) rows, and a DTensor's masked partial
    # sum reduced before any reshape: DTensor's gather from vocab-split
    # logits masks its result in the gather's own 2-D shape
    gold = whole_partials(torch.gather(
        logits.reshape(-1, logits.shape[-1]), 1,
        safe.reshape(-1, 1))).reshape(safe.shape)
    nll = torch.where(valid, lse - gold, 0.0)
    return nll.sum() / valid.sum().clamp_min(1)
