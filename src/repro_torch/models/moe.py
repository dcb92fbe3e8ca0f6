"""Token-choice top-k MoE with an optional shared expert (GShard-style).

The port's counterpart of `repro.models.moe`.  Tokens are grouped
(group_size tokens a group); within a group every expert accepts up to
C = max(ceil(g * top_k * cf / E), top_k) tokens, in token order, and the
(token, k) pairs past an expert's capacity are dropped, as in the
reference.

The dispatch `disp` and combine `comb` tensors (n, g, E, C) meet the
tokens and the experts' outputs in the reference's einsums, written
here as batched matmuls (`MoE.forward`).  The
reference builds them from a one-hot (n, g, K, E, C + 1) of every
(token, k)'s slot, 1.35 GB in bf16 at granite's prefill; here each kept
(token, k) pair writes its 1 and its bf16 gate at (token, expert, slot)
by index instead.  No slot is written twice, so nothing is accumulated
and the result does not hang on the order of writes; `dispatch_onehot`
is the reference's one-hot form, and the CPU tests hold the two to each
other bit for bit.

Top-k is a stable descending sort sliced to k (`top_k`): the order of
`jax.lax.top_k`, ties to the lower expert index.  That order decides each
(token, k)'s capacity slot, so which tokens are dropped.  Expert counts
are integer counts; no float scatter-add (atomic on CUDA) is used.

Configs served:
  granite-moe-1b : 32 experts, top-8, d_expert 512, no shared expert
  qwen2-moe-a2.7b: 60 routed experts, top-4, d_expert 1408, one shared
                   expert (5632) with a sigmoid gate
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from .common import (CastWeights, ModelConfig, MoEConfig, init_normal, matmul,
                     shard)
from .mlp import sigmoid, silu


def padded_experts(moe: MoEConfig, tp: int) -> int:
    if tp <= 1:
        return moe.n_experts
    return math.ceil(moe.n_experts / tp) * tp


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, largest
    first, ties to the lower index: `jax.lax.top_k`'s order.  A stable
    sort keeps equal values in index order (torch.topk promises no order
    among ties on CUDA)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@dataclasses.dataclass
class Routing:
    """One MoE call's routing over (n groups, g tokens, k choices)."""
    probs: torch.Tensor    # (n, g, E) fp32 router softmax
    topv: torch.Tensor     # (n, g, K) fp32 gates, renormalised
    topi: torch.Tensor     # (n, g, K) int64 chosen experts, largest first
    slot: torch.Tensor     # (n, g, K) int64 position in the expert's queue
    keep: torch.Tensor     # (n, g, K) bool: slot < cap
    counts: torch.Tensor   # (E,) int64 (token, k) pairs an expert
    cap: int               # slots an expert takes a group
    aux: torch.Tensor      # () fp32 load-balance loss


def route_logits(moe: MoEConfig, logits: torch.Tensor) -> Routing:
    """The routing of router logits (n, g, E) fp32: the softmax over the
    real experts, top-k, each (token, k)'s slot in its expert's queue in
    token then k order, which slots fit the capacity, the expert counts
    and the load-balance loss.  Everything after the softmax is integer
    or a stable sort, so it is the same on any device for the same
    logits."""
    n, g, ep = logits.shape
    K = moe.top_k
    n_real = moe.n_experts
    logits = torch.where(torch.arange(ep, device=logits.device) < n_real,
                         logits, -1e30)
    # the max is a constant of the softmax's gradient, as in jax.nn.softmax
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    probs = e / e.sum(dim=-1, keepdim=True)
    topv, topi = top_k(probs, K)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)

    onehot = torch.nn.functional.one_hot(topi.reshape(n, g * K), ep)
    # load balance (Switch-style): E * sum_e fraction_e * prob_e
    counts = onehot.sum(dim=(0, 1))
    me = probs.mean(dim=(0, 1))
    ce = counts.float() / (n * g * K)
    aux = n_real * torch.sum(me * ce)

    cap = max(int(math.ceil(g * K * moe.capacity_factor / n_real)), K)
    # slot of (token, k): the (token', k') pairs up to it, in token then
    # k order, that chose the same expert, less one (a running count
    # along each expert's row of the one-hot)
    upto = torch.cumsum(onehot.transpose(1, 2), dim=2,
                        dtype=torch.int32)                     # (n,E,gK)
    slot = torch.gather(upto, 1, topi.reshape(n, 1, g * K)).reshape(
        n, g, K).long() - 1
    return Routing(probs, topv, topi, slot, slot < cap, counts, cap, aux)


def route_sharded(moe: MoEConfig, logits: DTensor) -> Routing:
    """route_logits of DTensor router logits whose groups (dim 0) are
    split over the batch axes and whose experts are whole: each rank
    routes its own groups (the sort, one-hots and running counts have no
    DTensor sharding rule, and no group's routing reads another's), and
    the load-balance loss is taken over all groups.  The Routing's probs
    and counts are DTensors (counts partial sums over the ranks that
    split the groups), its aux a DTensor scalar; its topv, topi, slot
    and keep are this rank's local tensors."""
    if any(not (p.is_replicate() or p.is_shard(0))
           for p in logits.placements):
        raise ValueError(f"route_sharded: router logits must split only "
                         f"their groups (dim 0), got {logits.placements}")
    r = route_logits(moe, logits.to_local())
    mesh = logits.device_mesh
    probs = DTensor.from_local(r.probs, mesh, logits.placements,
                               run_check=False)
    counts = DTensor.from_local(
        r.counts, mesh, tuple(Partial() if p.is_shard() else Replicate()
                              for p in logits.placements), run_check=False)
    n, g, _ = logits.shape
    me = probs.mean(dim=(0, 1))
    ce = counts.float() / (n * g * moe.top_k)
    aux = moe.n_experts * torch.sum(me * ce)
    return dataclasses.replace(r, probs=probs, counts=counts, aux=aux)


def _splits(t: torch.Tensor, dim: int) -> bool:
    """Whether DTensor `t` is sharded along `dim`."""
    return isinstance(t, DTensor) and any(
        p.is_shard(dim) for p in t.placements)


class MoE(CastWeights):
    """router (d, E), w_gate and w_up (E, d, f), w_down (E, f, d); with a
    shared expert also shared_gate, shared_up (d, fs), shared_down (fs, d)
    and shared_mix (d, 1).  fp32, read in the activation's dtype."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device, tp: int = 1):
        super().__init__()
        moe = cfg.moe
        self.cfg = cfg
        d, f = cfg.d_model, moe.d_expert
        ep = padded_experts(moe, tp)
        kw = dict(generator=generator, device=device)
        self.router = init_normal((d, ep), **kw)
        self.w_gate = init_normal((ep, d, f), **kw)
        self.w_up = init_normal((ep, d, f), **kw)
        self.w_down = init_normal((ep, f, d), **kw)
        if moe.n_shared:
            fs = moe.d_shared
            self.shared_gate = init_normal((d, fs), **kw)
            self.shared_up = init_normal((d, fs), **kw)
            self.shared_down = init_normal((fs, d), **kw)
            self.shared_mix = init_normal((d, 1), **kw)

    def groups(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, D) as (n, g, D) dispatch groups."""
        B, S, D = x.shape
        n_tok = B * S
        n_groups = max(n_tok // min(self.cfg.moe.group_size, n_tok), 1)
        return x.reshape(n_groups, n_tok // n_groups, D)

    def router_logits(self, xt: torch.Tensor) -> torch.Tensor:
        """The router's logits (n, g, E) for groups xt (n, g, D): a
        product in xt's dtype, then fp32."""
        return matmul(xt, self.weight("router", xt.dtype)).float()

    def route(self, xt: torch.Tensor) -> Routing:
        """The routing of groups xt (n, g, D).  DTensor logits are laid
        out with their groups on the batch axes and routed rank by rank
        (`route_sharded`)."""
        logits = self.router_logits(xt)
        if isinstance(logits, DTensor):
            return route_sharded(self.cfg.moe,
                                 shard(logits, "batch", None, None))
        return route_logits(self.cfg.moe, logits)

    def experts(self, xe: torch.Tensor) -> torch.Tensor:
        """The expert FFNs on their queues xe (E, n * C, D): each expert's
        slots of every group in one row, so each product is a bmm over the
        experts whose summed dim (D, then F) is whole on every rank."""
        dt = xe.dtype

        def w(name):
            return shard(self.weight(name, dt), "experts", None, None)
        gate = matmul(xe, w("w_gate"))
        up = matmul(xe, w("w_up"))
        h = shard(silu(gate) * up, "experts", "batch", None)
        return shard(matmul(h, w("w_down")), "experts", "batch", None)

    def dispatch(self, r: Routing, dtype: torch.dtype):
        """The dispatch and combine tensors (n, g, E, C) of routing r,
        written by index: 1 and the bf16 gate at (token, expert, slot) of
        each kept (token, k) pair, each slot written once.  A dropped pair
        writes to a spare slot C, cut off after (no host sync to select
        the kept pairs)."""
        n, g, _ = r.topi.shape
        ep = self.router.shape[-1]
        dev = r.topi.device
        at = (torch.arange(n, device=dev)[:, None, None],
              torch.arange(g, device=dev)[None, :, None], r.topi,
              torch.where(r.keep, r.slot, r.cap))
        disp = torch.zeros((n, g, ep, r.cap + 1), dtype=dtype, device=dev)
        comb = torch.zeros_like(disp)
        disp[at] = 1
        comb[at] = r.topv.to(dtype)
        return disp[..., :r.cap], comb[..., :r.cap]

    def dispatch_onehot(self, r: Routing, dtype: torch.dtype):
        """The same tensors as the reference builds them: one-hot experts
        and slots (n, g, K, E, C + 1) contracted over k by einsum.  Each
        sum has one non-zero term, so the result is exact."""
        ep = self.router.shape[-1]
        onehot = torch.nn.functional.one_hot(r.topi, ep)
        pos = torch.where(onehot.bool() & r.keep[..., None],
                          r.slot[..., None], r.cap)
        pos_oh = torch.nn.functional.one_hot(
            pos, r.cap + 1)[..., :r.cap].float()
        disp = torch.einsum("ngke,ngkec->ngec", onehot.float(), pos_oh)
        comb = torch.einsum("ngk,ngke,ngkec->ngec",
                            r.topv.to(dtype).float(), onehot.float(), pos_oh)
        return disp.to(dtype), comb.to(dtype)

    def forward(self, x: torch.Tensor):
        """x: (B, S, D) -> (out (B, S, D), aux).

        The reference's three einsums are written as bmm of laid-out
        operands: dispatch (n, E * C, g) @ (n, g, D), the experts over E,
        and combine (n, g, C * E) @ (n, C * E, D).  The combine sums a
        token's K terms in slot order, as torch.einsum of the reference's
        "ngec,necd->ngd" does.  With the experts split over ranks it
        takes (n, g, E * C) instead: every reshape then keeps a split dim
        first among the dims it merges (the experts ahead of their slots,
        the groups ahead of theirs), which DTensor lays out in every torch
        release, and the terms are summed in expert order."""
        B, S, D = x.shape
        dt = x.dtype
        xt = self.groups(x)
        r = self.route(xt)
        disp, comb = self.dispatch(r, dt)
        if isinstance(r.probs, DTensor):      # this rank's groups' tensors
            disp, comb = (DTensor.from_local(t, r.probs.device_mesh,
                                             r.probs.placements,
                                             run_check=False)
                          for t in (disp, comb))
        n, g, ep, cap = disp.shape
        disp, comb = (shard(t, "batch", None, "experts", None)
                      for t in (disp, comb))
        xt = shard(xt, "batch", None, None)
        xin = matmul(disp.reshape(n, g, ep * cap).transpose(1, 2), xt)
        xe = shard(xin.reshape(n, ep, cap, D).transpose(0, 1)
                   .reshape(ep, n * cap, D), "experts", "batch", None)
        y = self.experts(xe).reshape(ep, n, cap, D)
        if _splits(comb, 2):
            comb = comb.reshape(n, g, ep * cap)
            y = y.transpose(0, 1).reshape(n, ep * cap, D)
        else:
            comb = comb.transpose(2, 3).reshape(n, g, cap * ep)
            y = y.permute(1, 2, 0, 3).reshape(n, cap * ep, D)
        out = matmul(comb, shard(y, "batch", "experts", None))
        if self.cfg.moe.n_shared:
            # laid out as the MLP's products (models/mlp.py), and so
            # their gradients: left to DTensor, the down weight's
            # gradient was taken whole on every "model" rank under "2d"
            sg = shard(matmul(xt, self.weight("shared_gate", dt)),
                       "batch", None, "mlp")
            su = shard(matmul(xt, self.weight("shared_up", dt)),
                       "batch", None, "mlp")
            sh = matmul(shard(silu(sg) * su, "batch", None, "mlp"),
                        self.weight("shared_down", dt))
            mix = sigmoid(matmul(xt, self.weight("shared_mix", dt)))
            out = out + mix * sh
        return shard(out.reshape(B, S, D), "batch", "seq", "embed"), r.aux
