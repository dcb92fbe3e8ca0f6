"""Griffin-style recurrent block (RecurrentGemma): causal conv + RG-LRU.

The port's counterpart of `repro.models.rglru`.  The RG-LRU recurrence
h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) is elementwise in the
feature dimension; train and prefill run it over the whole sequence,
decode carries a (B, R) state.

Block layout (Griffin):  x -> [W_x -> conv4 -> RG-LRU] * gelu(W_y x) -> W_out

impl = "kernel" (the counterpart of the reference's Pallas kernels) runs
the train/prefill scan through kernels.ops.rglru: the CUDA kernel on the
card, its sequential plain version on the CPU.  impl = "einsum" runs the
reference model's own math, an associative scan with its combine
(l0*r0, r0*l1 + r1) in the reference's recursion order.  The two differ by
fp32 ulps (the sums are taken in another order).  Decode is the
reference's single elementwise step on either impl.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops
from .common import CastWeights, ModelConfig, init_normal, matmul, shard
from .mlp import gelu_tanh, sigmoid

C_RGLRU = 8.0
CONV_WIDTH = 4


def make_cache(cfg: ModelConfig, batch: int, *,
               device: torch.device) -> dict:
    """Decode state of one recurrent layer: the RG-LRU state h (B, R) and
    the conv's last CONV_WIDTH - 1 inputs (B, 3, R), both fp32."""
    r = cfg.d_model
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, CONV_WIDTH - 1, r),
                                dtype=torch.float32, device=device)}


def _conv4(x, w, b, history):
    """Causal width-4 conv along S in x's dtype.  history: (B, 3, R) from
    the decode cache, or None (zeros).  Returns (out, the last 3 inputs)."""
    dt = x.dtype
    if history is None:
        pad = x.new_zeros((x.shape[0], CONV_WIDTH - 1, x.shape[2]))
    else:
        pad = history.to(dt)
    xp = torch.cat([pad, x], dim=1)
    L = xp.shape[1]
    out = None
    for k in range(CONV_WIDTH):
        term = xp[:, CONV_WIDTH - 1 - k: L - k] * w[k].to(dt)
        out = term if out is None else out + term
    return out + b.to(dt), xp[:, -(CONV_WIDTH - 1):]


def _softplus(x):
    """jax.nn.softplus, i.e. logaddexp(x, 0): max(x, 0) + log1p(exp(-|x|))
    (not torch's thresholded softplus)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along axis 1 (a may be one longer)."""
    out = a.new_empty((a.shape[0], a.shape[1] + b.shape[1]) + a.shape[2:])
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _combine(l, r):
    return l[0] * r[0], r[0] * l[1] + r[1]


def associative_scan(a, b):
    """jax.lax.associative_scan(combine, (a, b), axis=1) with the
    reference's combine, in its recursion order: returns h (B, S, R)."""
    def scan(elems):
        n = elems[0].shape[1]
        if n < 2:
            return elems
        odd = scan(_combine([e[:, 0:-1:2] for e in elems],
                            [e[:, 1::2] for e in elems]))
        if n % 2 == 0:
            even = _combine([e[:, :-1] for e in odd],
                            [e[:, 2::2] for e in elems])
        else:
            even = _combine(odd, [e[:, 2::2] for e in elems])
        even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
        return [_interleave(e, o) for e, o in zip(even, odd)]
    return scan([a, b])[1]


class RGLRU(CastWeights):
    """The recurrent sublayer's weights, with the reference's names and
    shapes (R = d_model): w_x, w_y (d, R); conv_w (4, R), conv_b (R,);
    w_a, w_i (R, R), b_a, b_i (R,); lam (R,) at scale 1; w_out (R, d).
    Biases start at zero; all fp32, read in the activation's dtype."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        d = r = cfg.d_model
        kw = dict(generator=generator, device=device)
        self.w_x = init_normal((d, r), **kw)
        self.w_y = init_normal((d, r), **kw)
        self.conv_w = init_normal((CONV_WIDTH, r), **kw)
        self.conv_b = init_normal((r,), zero=True, **kw)
        self.w_a = init_normal((r, r), **kw)
        self.b_a = init_normal((r,), zero=True, **kw)
        self.w_i = init_normal((r, r), **kw)
        self.b_i = init_normal((r,), zero=True, **kw)
        self.lam = init_normal((r,), scale=1.0, **kw)
        self.w_out = init_normal((r, d), **kw)

    def _gates(self, xi):
        """(a, b) of the recurrence, fp32: a = exp(log_a) and b =
        sqrt(max(1 - a^2, 1e-12)) * i * x, log_a = -8 softplus(lam) * r."""
        dt = xi.dtype
        r = sigmoid(matmul(xi, self.weight("w_a", dt)) + self.b_a.to(dt))
        i = sigmoid(matmul(xi, self.weight("w_i", dt)) + self.b_i.to(dt))
        log_a = -C_RGLRU * _softplus(self.lam.float()) * r.float()
        a = torch.exp(log_a)
        mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                          1e-12))
        return a, mult * (i.float() * xi.float())

    def forward(self, x, *, mode: str, cache: dict | None = None,
                impl: str = "einsum"):
        """x: (B, S, D) -> (out (B, S, D), new cache or None)."""
        dt = x.dtype
        xi = matmul(x, self.weight("w_x", dt))
        gate = gelu_tanh(matmul(x, self.weight("w_y", dt)))
        xi = shard(xi, "batch", None, "mlp")
        if mode in ("train", "prefill"):
            xi, conv_hist = _conv4(xi, self.conv_w, self.conv_b, None)
            a, b = self._gates(xi)
            if impl == "kernel":
                h, h_last = kops.rglru(a.contiguous(), b.contiguous())
            elif impl == "einsum":
                h = associative_scan(a, b)
                h_last = h[:, -1]
            else:
                raise ValueError(f"impl must be 'kernel' or 'einsum', got "
                                 f"{impl!r}")
            new_cache = None
            if mode == "prefill":
                # a copy, so the cache does not hold all of h alive
                new_cache = {"h": h_last.contiguous(),
                             "conv": conv_hist.float()}
            h = h.to(dt)
        elif mode == "decode":
            if x.shape[1] != 1 or cache is None:
                raise ValueError("decode takes one token and a cache")
            xi, conv_hist = _conv4(xi, self.conv_w, self.conv_b,
                                   cache["conv"])
            a, b = self._gates(xi)
            h_new = a[:, 0] * cache["h"] + b[:, 0]
            new_cache = {"h": h_new, "conv": conv_hist.float()}
            h = h_new[:, None, :].to(dt)
        else:
            raise ValueError(mode)
        out = matmul(h * gate, self.weight("w_out", dt))
        return shard(out, "batch", "seq", "embed"), new_cache
