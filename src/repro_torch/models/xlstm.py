"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential) -- arXiv:2405.04517.

The port's counterpart of `repro.models.xlstm`.  mLSTM uses exponential
input gates and sigmoid forget gates with running max-stabilisation:
train and prefill run the chunkwise-parallel form (`mlstm_chunk`, chunks
of CHUNK steps: attention-like within a chunk, the recurrent state
between chunks), decode the recurrence.  sLSTM runs its cell step by
step in a Python loop on the device, the four gates' block-diagonal
recurrent products as one batched fp32 product a step; the input
projections of all steps are taken at once before the loop (each row is
the same bf16 product the reference takes a step).  Every step of the
recurrences runs in fp32; the sigmoids and log-sigmoids there are
torch's fused fp32 ops, an fp32 place or so from the reference's
formulas.  No Pallas kernel of the reference stands behind either
block, so none is launched here.

Block layouts (official xLSTM):
  mLSTM: up-proj x2 (pf=2) -> conv4 -> q,k,v -> cell -> groupnorm
         -> * silu(gate branch) -> down-proj
  sLSTM: conv4 -> cell (block-diag recurrent R over heads) -> groupnorm
         -> gated FFN (pf=4/3)
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import (CastWeights, ModelConfig, init_normal,
                     local_elementwise, matmul, shard, whole_for_split)
from .mlp import gelu_tanh, silu
from .rglru import CONV_WIDTH, _conv4

CHUNK = 256
GATES = ("z", "i", "f", "o")


def group_norm(x: torch.Tensor, w: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Per-head norm over the head dim with the population variance.
    x: (B, S, H, hd) -> (B, S, H * hd) in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    xn = (xf - mu) * torch.rsqrt(var + eps)
    B, S, H, hd = x.shape
    return (xn.reshape(B, S, H * hd) * (1.0 + w.float())).to(x.dtype)


def _scale(hd: int) -> float:
    """1 / sqrt(hd) in fp32, as the reference computes it."""
    return (1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))).item()


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def make_mlstm_cache(cfg: ModelConfig, batch: int, *,
                     device: torch.device) -> dict:
    """Decode state of one mLSTM layer, fp32: the matrix memory S (B, H,
    hd, hd), the normaliser n (B, H, hd), the stabiliser m (B, H) and the
    conv's last CONV_WIDTH - 1 inputs (B, 3, 2d)."""
    h = cfg.n_heads
    hd = 2 * cfg.d_model // h

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {"S": z(batch, h, hd, hd), "n": z(batch, h, hd), "m": z(batch, h),
            "conv": z(batch, CONV_WIDTH - 1, 2 * cfg.d_model)}


def mlstm_chunk(q, k, v, logf, logi, state):
    """One chunk of the stabilised chunkwise mLSTM, fp32.  q, k, v:
    (B, H, L, hd); logf, logi: (B, H, L); state (S, n, m) carried.
    Returns (h (B, H, L, hd), the state at the chunk's end)."""
    S_p, n_p, m_p = state
    L, hd = q.shape[-2], q.shape[-1]
    b = torch.cumsum(logf, dim=-1)                       # log decay
    # stabiliser per position: max over (inter, intra j <= i)
    intra = b[..., :, None] - b[..., None, :] + logi[..., None, :]
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    intra = torch.where(tri, intra, -math.inf)
    m_i = torch.maximum(m_p[..., None] + b, intra.amax(dim=-1))

    scale = _scale(hd)
    scores = (q @ k.transpose(-1, -2)) * scale
    w_ij = torch.exp(intra - m_i[..., None])
    num_intra = (scores * w_ij) @ v
    n_intra = w_ij @ k

    w_inter = torch.exp(m_p[..., None] + b - m_i)
    num_inter = (q @ S_p) * w_inter[..., None] * scale
    n_inter = n_p[:, :, None, :] * w_inter[..., None]

    num = num_intra + num_inter
    nvec = n_intra + n_inter
    den = torch.abs((q[..., None, :] @ nvec[..., :, None])[..., 0, 0]) * scale
    h = num / torch.maximum(den, torch.exp(-m_i))[..., None]

    # the state at the end of the chunk
    last = b[..., -1]
    m_new = torch.maximum(m_p + last,
                          (last[..., None] - b + logi).amax(dim=-1))
    w_upd = torch.exp(last[..., None] - b + logi - m_new[..., None])
    decay = torch.exp(m_p + last - m_new)
    wk = w_upd[..., None] * k
    S_new = S_p * decay[..., None, None] + wk.transpose(-1, -2) @ v
    n_new = n_p * decay[..., None] + (w_upd[..., None, :] @ k)[..., 0, :]
    return h, (S_new, n_new, m_new)


class MLSTM(CastWeights):
    """The mLSTM block's weights, with the reference's names and shapes
    (dm = 2d, hd = dm / H): w_up, w_gate (d, dm); conv_w (4, dm), conv_b
    (dm,); w_q, w_k, w_v (dm, H, hd); w_i, w_f (dm, H), b_i, b_f (H,)
    (b_f at scale 1); gn (dm,); w_down (dm, d)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        dm = 2 * d
        hd = dm // h
        self.heads = h
        kw = dict(generator=generator, device=device)
        self.w_up = init_normal((d, dm), **kw)
        self.w_gate = init_normal((d, dm), **kw)
        self.conv_w = init_normal((CONV_WIDTH, dm), **kw)
        self.conv_b = init_normal((dm,), zero=True, **kw)
        self.w_q = init_normal((dm, h, hd), **kw)
        self.w_k = init_normal((dm, h, hd), **kw)
        self.w_v = init_normal((dm, h, hd), **kw)
        self.w_i = init_normal((dm, h), **kw)
        self.b_i = init_normal((h,), zero=True, **kw)
        self.w_f = init_normal((dm, h), **kw)
        self.b_f = init_normal((h,), scale=1.0, **kw)
        self.gn = init_normal((dm,), zero=True, **kw)
        self.w_down = init_normal((dm, d), **kw)

    def project(self, x, history=None):
        """The cell's inputs from x (B, S, D): q, k, v (B, H, S, hd) and
        the log input and forget gates (B, H, S), fp32 from bf16
        products; the output gate's branch (B, S, 2D) in x's dtype; and
        the conv's last inputs (history: the decode cache's, or None)."""
        dt = x.dtype
        B, S, _ = x.shape
        up = matmul(x, self.weight("w_up", dt))
        gate = matmul(x, self.weight("w_gate", dt))
        ci, conv_hist = _conv4(up, self.conv_w, self.conv_b, history)
        ci = silu(ci)

        def heads(name):        # (B, H, S, hd)
            w = self.weight(name, dt)
            qkv = matmul(ci, w.reshape(w.shape[0], -1))
            return whole_for_split(qkv, 2, self.heads).view(
                B, S, self.heads, -1).transpose(1, 2).float()

        def gate_pre(name):     # (B, H, S): product and bias in bf16
            w = self.weight(f"w_{name}", dt)
            return (matmul(ci, w) + getattr(self, f"b_{name}").to(dt)
                    ).float().transpose(1, 2)

        return (heads("w_q"), heads("w_k"), heads("w_v"),
                local_elementwise(F.logsigmoid, gate_pre("f")),
                gate_pre("i"), gate, conv_hist)

    @staticmethod
    def chunks(q, k, v, logf, logi):
        """The chunkwise-parallel pass over a whole sequence from a fresh
        state: (h (B, H, S, hd), the final (S, n, m))."""
        B, H, S, hd = q.shape
        L = min(CHUNK, S)
        if S % L:
            raise ValueError(f"seq {S} not divisible by chunk {L}")
        state = (q.new_zeros((B, H, hd, hd)), q.new_zeros((B, H, hd)),
                 torch.full((B, H), -1e30, dtype=torch.float32,
                            device=q.device))
        hs = []
        for c0 in range(0, S, L):
            sl = slice(c0, c0 + L)
            h, state = mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                   logf[..., sl], logi[..., sl], state)
            hs.append(h)
        return torch.cat(hs, dim=2), state

    @staticmethod
    def step(q, k, v, logf, logi, state):
        """One decode step of the recurrence from state (S, n, m); q, k,
        v (B, H, 1, hd).  Returns (h (B, H, 1, hd), the new state)."""
        S_p, n_p, m_p = state
        lf, li = logf[..., 0], logi[..., 0]
        m_new = torch.maximum(lf + m_p, li)
        fp = torch.exp(lf + m_p - m_new)
        ip = torch.exp(li - m_new)
        kt, vt, qt = k[:, :, 0], v[:, :, 0], q[:, :, 0]
        S_new = fp[..., None, None] * S_p + ip[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n_new = fp[..., None] * n_p + ip[..., None] * kt
        scale = _scale(q.shape[-1])
        num = (qt[..., None, :] @ S_new)[..., 0, :] * scale
        den = torch.abs((qt[..., None, :] @ n_new[..., :, None])
                        [..., 0, 0]) * scale
        h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
        return h[:, :, None, :], (S_new, n_new, m_new)

    def forward(self, x, *, mode: str, cache: dict | None = None):
        """x: (B, S, D) -> (out (B, S, D), new cache or None)."""
        dt = x.dtype
        if mode == "decode":
            if x.shape[1] != 1 or cache is None:
                raise ValueError("decode takes one token and a cache")
            q, k, v, logf, logi, gate, conv_hist = self.project(
                x, cache["conv"])
            h, state = self.step(q, k, v, logf, logi,
                                 (cache["S"], cache["n"], cache["m"]))
        elif mode in ("train", "prefill"):
            q, k, v, logf, logi, gate, conv_hist = self.project(x)
            h, state = self.chunks(q, k, v, logf, logi)
        else:
            raise ValueError(mode)
        new_cache = None
        if mode in ("prefill", "decode"):
            new_cache = {"S": state[0], "n": state[1], "m": state[2],
                         "conv": conv_hist.float()}
        h = group_norm(h.transpose(1, 2), self.gn).to(dt)   # (B, S, 2D)
        out = matmul(h * silu(gate), self.weight("w_down", dt))
        return shard(out, "batch", "seq", "embed"), new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def make_slstm_cache(cfg: ModelConfig, batch: int, *,
                     device: torch.device) -> dict:
    """Decode state of one sLSTM layer, fp32: the cell c, normaliser n,
    output h and stabiliser m (B, d), and the conv's last CONV_WIDTH - 1
    inputs (B, 3, d)."""
    d = cfg.d_model

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {"c": z(batch, d), "n": z(batch, d), "h": z(batch, d),
            "m": z(batch, d), "conv": z(batch, CONV_WIDTH - 1, d)}


class SLSTM(CastWeights):
    """The sLSTM block's weights, with the reference's names and shapes
    (hd = d / H): conv_w (4, d), conv_b (d,); gn (d,); w_ff1, w_ff1g
    (d, 4d/3), w_ff2 (4d/3, d); for each gate g of z, i, f, o: w_g (d, d),
    r_g (H, hd, hd) and b_g (d,)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        hd = d // h
        f = d * 4 // 3
        self.heads = h
        kw = dict(generator=generator, device=device)
        self.conv_w = init_normal((CONV_WIDTH, d), **kw)
        self.conv_b = init_normal((d,), zero=True, **kw)
        self.gn = init_normal((d,), zero=True, **kw)
        self.w_ff1 = init_normal((d, f), **kw)
        self.w_ff1g = init_normal((d, f), **kw)
        self.w_ff2 = init_normal((f, d), **kw)
        for g in GATES:
            setattr(self, f"w_{g}", init_normal((d, d), **kw))
            setattr(self, f"r_{g}", init_normal((h, hd, hd), **kw))
            setattr(self, f"b_{g}", init_normal((d,), zero=True, **kw))

    def recurrent(self):
        """The four gates' recurrent weights side by side, (H, hd, 4 hd)
        fp32, and their biases (4, D), in GATES order."""
        r = torch.cat([getattr(self, f"r_{g}") for g in GATES], dim=2)
        b = torch.stack([getattr(self, f"b_{g}") for g in GATES])
        return r.float(), b.float()

    def cell(self, wx, state: tuple, r, b) -> tuple:
        """One time step.  wx: the gates' input products (B, 4, D) fp32;
        state (c, n, h, m) fp32; r, b from `recurrent`.  Returns the new
        state."""
        c, n, h, m = state
        B, D = h.shape
        H = self.heads
        # the block-diagonal recurrent product of all four gates at once
        rh = torch.bmm(whole_for_split(h, 1, H).view(B, H, -1)
                       .transpose(0, 1), r)                  # (H, B, 4hd)
        rh = whole_for_split(rh, 2, len(GATES)).view(
            H, B, len(GATES), -1).permute(1, 2, 0, 3).reshape(
                B, len(GATES), D)
        pre = wx + rh + b
        z = torch.tanh(pre[:, 0])
        itil = pre[:, 1]
        ftil = local_elementwise(F.logsigmoid, pre[:, 2])
        o = torch.sigmoid(pre[:, 3])
        m_new = torch.maximum(ftil + m, itil)
        ip = torch.exp(itil - m_new)
        fp = torch.exp(ftil + m - m_new)
        c_new = fp * c + ip * z
        n_new = fp * n + ip
        h_new = o * c_new / torch.clamp_min(n_new, 1.0)
        return c_new, n_new, h_new, m_new

    def project(self, x, history=None):
        """Each gate's input product for every step, (B, S, 4, D) fp32
        from bf16 products in GATES order, and the conv's last inputs
        (history: the decode cache's, or None)."""
        ci, conv_hist = _conv4(x, self.conv_w, self.conv_b, history)
        ci = silu(ci)
        return (torch.stack([matmul(ci, self.weight(f"w_{g}", x.dtype))
                             for g in GATES], dim=2).float(), conv_hist)

    def scan(self, wx, state: tuple):
        """The cell over every step of wx (B, S, 4, D) from state (c, n,
        h, m): (h (B, S, D) fp32, the last state)."""
        r, b = self.recurrent()
        hs = []
        for t in range(wx.shape[1]):
            state = self.cell(wx[:, t], state, r, b)
            hs.append(state[2])
        return torch.stack(hs, dim=1), state

    def forward(self, x, *, mode: str, cache: dict | None = None):
        """x: (B, S, D) -> (out (B, S, D), new cache or None)."""
        dt = x.dtype
        B, S, D = x.shape
        if mode == "decode":
            if S != 1 or cache is None:
                raise ValueError("decode takes one token and a cache")
            state = (cache["c"], cache["n"], cache["h"], cache["m"])
            wx, conv_hist = self.project(x, cache["conv"])
        elif mode in ("train", "prefill"):
            z = torch.zeros((B, D), dtype=torch.float32, device=x.device)
            state = (z, z, z, torch.full((B, D), -1e30, dtype=torch.float32,
                                         device=x.device))
            wx, conv_hist = self.project(x)
        else:
            raise ValueError(mode)
        h, state = self.scan(wx, state)
        new_cache = None
        if mode in ("prefill", "decode"):
            new_cache = {"c": state[0], "n": state[1], "h": state[2],
                         "m": state[3], "conv": conv_hist.float()}

        h = group_norm(whole_for_split(h, 2, self.heads).view(
            B, S, self.heads, -1), self.gn).to(dt)
        up = matmul(h, self.weight("w_ff1", dt))
        gate = matmul(h, self.weight("w_ff1g", dt))
        out = matmul(gelu_tanh(gate) * up, self.weight("w_ff2", dt))
        return shard(out, "batch", "seq", "embed"), new_cache
