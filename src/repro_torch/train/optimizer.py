"""AdamW + cosine schedule + global-norm clipping, in fp32.

The port's counterpart of `repro.train.optimizer`.  Parameters,
gradients and the moments are flat dicts of tensors keyed by the model's
parameter names (the reference's are trees of the same leaves); the
state is {"m", "v", "step"}, `step` an int32 scalar on the parameters'
device.  `adamw_update` writes the new parameters and moments into the
given tensors (no second copy of a model's state on the card) and
returns them.

Each scalar of the schedule is computed on the device in fp32, op by op
as the reference writes it; a division by a Python scalar is taken as a
division by an fp32 tensor, because CUDA's `tensor / scalar` multiplies
by the reciprocal, which can differ from the quotient in the last place.
"""
from __future__ import annotations

import dataclasses
import math

import torch

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    """`value` as an fp32 scalar on like's device (a fill, no copy)."""
    return torch.full((), value, dtype=_F32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (an integer scalar tensor): linear
    warm-up over warmup_steps, then a cosine down to min_lr_frac * lr at
    total_steps."""
    step = step.to(_F32)
    warm = torch.clamp_max(step / _const(step, max(cfg.warmup_steps, 1)),
                           1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / _const(step, max(cfg.total_steps - cfg.warmup_steps, 1)),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    """Zero moments (fp32, one per parameter, laid out as it: a DTensor
    parameter's moments are DTensors of its placements) and step 0."""
    device = next(iter(params.values())).device
    zeros = {k: torch.zeros_like(p, dtype=_F32, requires_grad=False)
             for k, p in params.items()}
    return {"m": zeros,
            "v": {k: torch.zeros_like(p, dtype=_F32, requires_grad=False)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(_F32)))
                          for leaf in tree.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: dict):
    """One AdamW step.  The gradients are clipped by their global norm
    before the moments; the bias corrections 1 - b ** step are fp32; the
    decoupled weight decay applies to every parameter (norms and
    embeddings too), as in the reference.  Returns (params, state,
    grad norm), params and moments updated in place."""
    if set(grads) != set(params) or set(state["m"]) != set(params):
        raise ValueError("params, grads and the moments must have the "
                         "same keys")
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(
        _const(gnorm, cfg.clip_norm) / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = schedule(cfg, step)
    b1t = 1.0 - cfg.b1 ** step.to(_F32)
    b2t = 1.0 - cfg.b2 ** step.to(_F32)
    for k, p in params.items():
        g = grads[k].to(_F32) * scale
        m = state["m"][k].mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v = state["v"][k].mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        upd = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
        upd += cfg.weight_decay * p
        p.sub_(lr * upd)
    return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm
