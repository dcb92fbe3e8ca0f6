"""The bf16 attention kernel's arithmetic, on the CPU.

The wgmma kernel (kernels/csrc/flash_attention.cu, bf16 entry) takes
q.k^T of bf16 values summed in fp32, keeps p and l in fp32, and computes
p.v as two bf16 products, hi.v + lo.v with hi = bf16(p) and
lo = bf16(p - hi), summed in fp32, rounding the output once to bf16.
`flash_attention_bf16_model` is that rounding in plain PyTorch.  It is
held here against the plain version the card holds the kernel to, at the
card's bf16 limit (chip_smoke.py's FA_TOL: |got - plain| <= 2e-5 +
(2e-5 + 2**-7)|plain|), on the cases of tests/test_torch_attention.py and
recurrentgemma's hd 256 with a window.  p rounded once to bf16 must miss
that limit: it moves the output by several bf16 places.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

BF16_PLACE = 2.0 ** -7
ATOL, RTOL = 2e-5, 2e-5 + BF16_PLACE

CASES = [  # (S, H, Hkv, hd, window, softcap, causal)
    (512, 4, 2, 64, 0, 0.0, True),
    (512, 4, 4, 128, 0, 50.0, True),
    (1024, 8, 1, 64, 256, 0.0, True),
    (512, 6, 2, 80, 0, 0.0, True),
    (512, 4, 2, 120, 64, 0.0, True),
    (256, 4, 2, 32, 0, 0.0, False),
    (512, 2, 1, 256, 200, 0.0, True),
]


def _excess(got, want) -> float:
    """max |got - want| / (ATOL + RTOL |want|): at most 1 within the
    limit."""
    want = want.float()
    return float(((got.float() - want).abs() / (ATOL + RTOL * want.abs()))
                 .max())


def _run(case, split):
    S, H, Hkv, hd, window, cap, causal = case
    rng = np.random.default_rng(S + H + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .bfloat16() for shape in ((2, S, H, hd), (2, S, Hkv, hd),
                                         (2, S, Hkv, hd)))
    kw = dict(causal=causal, window=window, softcap=cap, scale=hd ** -0.5)
    got = fa.flash_attention_bf16_model(q, k, v, split=split, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    return _excess(got, want)


@pytest.mark.parametrize("case", CASES)
def test_split_p_is_within_the_bf16_limit(case):
    assert _run(case, split=True) <= 1.0


@pytest.mark.parametrize("case", CASES)
def test_p_rounded_once_misses_the_bf16_limit(case):
    assert _run(case, split=False) > 1.0
