"""The fp32 attention kernel's tile plan and its numerics, on the CPU.

`repro_torch.kernels.flash_attention.simt_plan` is the one copy of the
fp32 SIMT kernel's tiling (kernels/csrc/flash_attention.cu): the wrapper
passes it to the kernel's entry, which launches the template that the
source's FA_SIMT_TEMPLATES line builds or refuses.  Nothing here runs the
kernel; every plan the wrapper can ask for (a head dim that is a multiple
of 8 up to 256) is held to what an H100 takes and to the kernel's own
tiling rules, and to the head dims of chip_smoke.py's cases and of the ten
configs.

`flash_attention_fp32_model` is the kernel's arithmetic in PyTorch: the
online softmax over the plan's query blocks and kv tiles, the tiles the
kernel skips skipped, scores kept times log2 e with the mask applied after
the scaling, p = 2^(y - m).  On inputs made from a numpy seed it is held
within 2e-5 (chip_smoke.py's FA_TOL["float32"], the tolerance the card
holds the kernel to) of the plain version and of the reference's
`repro.kernels.ops.flash_attention` (the Pallas kernel in interpret mode),
on ragged S, rows wholly masked in a tile (a window narrower than a tile),
a softcap, no causal mask and hd 100 padded to 104.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import ops as jops
from repro_torch import configs
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa

SMEM_BLOCK_MAX = 232_448
REGISTERS_SM = 65_536
HEAD_DIMS = list(range(8, 257, 8))
ATOL, RTOL = chip_smoke.FA_TOL["float32"]


def _source() -> str:
    return (build.CSRC / "flash_attention.cu").read_text()


def _built_templates() -> set:
    """(HDP, BQ, BK, STAGES) of FA_SIMT_TEMPLATES in the kernel's source."""
    line = re.search(r"#define FA_SIMT_TEMPLATES\(X\)((?:.*\\\n)*.*)",
                     _source())
    assert line, "no FA_SIMT_TEMPLATES line in flash_attention.cu"
    return {tuple(int(x) for x in m) for m in
            re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", line.group(1))}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_simt_plan_fits_the_card(hd):
    p = fa.simt_plan(hd)
    assert hd <= p.hdp <= 256 and p.hdp % 32 == 0
    assert p.smem <= SMEM_BLOCK_MAX
    # Q, the K and V rings, p with its padded rows
    assert p.smem == 4 * (p.bq * p.hdp + 2 * p.stages * p.bkv * p.hdp
                          + p.bq * (p.bkv + fa.SIMT_PAD))
    # threads: SIMT_ROWS rows x SIMT_COLS columns of O each, whole warps,
    # a row group's lanes within one warp, at most 255 registers each
    groups, lanes = p.bq // fa.SIMT_ROWS, p.hdp // fa.SIMT_COLS
    assert p.threads == groups * lanes and p.threads % 32 == 0
    assert p.threads <= 1024 and 32 % lanes == 0
    assert REGISTERS_SM // p.threads >= 255
    # a thread's rows share row & 7 (Q's swizzle)
    assert p.bq % (8 * fa.SIMT_ROWS) == 0
    # S's lanes: KL key lanes x DS slices of the head dim, whole float4
    # steps of keys, the slices a power of two of at least 8 float4 columns
    ds = lanes // 8 if lanes > 8 else 1
    kl = lanes // ds
    assert p.bkv % (4 * kl) == 0 and (p.bkv // kl) % ds == 0
    nch = p.hdp // 4 // ds
    assert nch >= 8 and nch & (nch - 1) == 0
    assert p.stages >= 2


def test_every_simt_plan_is_a_built_template():
    built = _built_templates()
    plans = {(p.hdp, p.bq, p.bkv, p.stages)
             for p in map(fa.simt_plan, HEAD_DIMS)}
    assert plans == built, (plans, built)


def test_simt_plan_covers_the_cases_and_the_configs():
    hds = {-(-c[5] // 8) * 8 for c in chip_smoke.FA_CASES}
    for arch in configs.all_archs():
        for smoke in (False, True):
            cfg = configs.get(arch, smoke=smoke)
            if any(b.startswith("attn") for b in cfg.block_pattern):
                hds.add(-(-cfg.head_dim // 8) * 8)
    assert {128, 120, 256, 64, 80, 104, 32, 16} <= hds
    for hd in sorted(hds):
        p = fa.simt_plan(hd)
        assert p.hdp >= hd and p.smem <= SMEM_BLOCK_MAX


@pytest.mark.parametrize("hd", [0, 4, 12, 260, 264, 512])
def test_simt_plan_refuses_other_head_dims(hd):
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.simt_plan(hd)


def test_fp32_entry_uses_no_tensor_core_instruction():
    """The fp32 entry's source, from its banner to its end marker, names
    no mma, wgmma or TF32 (chip_smoke.py's phase 7 check): every product
    and sum on the FMA units."""
    src = _source()
    assert "flash_fwd_simt" in src[src.index("// fp32 entry: the SIMT"):
                                   src.index("// end of the fp32 entry")]
    assert chip_smoke.simt_tensor_core_words() == []
    assert chip_smoke.attention_template_counts() == (
        3, len(_built_templates()))


@pytest.mark.parametrize("q0,q_last,T,bkv,causal,window,want", [
    (0, 127, 2048, 64, True, 0, range(0, 2)),
    (1920, 2047, 2048, 64, True, 0, range(0, 32)),
    (1920, 2047, 2048, 64, False, 0, range(0, 32)),
    (128, 255, 1000, 64, True, 16, range(1, 4)),
    (896, 999, 1000, 64, False, 300, range(9, 16)),
    (0, 63, 10, 32, False, 0, range(0, 1)),
])
def test_kv_tiles_skip_rule(q0, q_last, T, bkv, causal, window, want):
    got = fa.kv_tiles(q0, q_last, T, bkv, causal, window)
    assert got == want
    # every pair a skipped tile holds is masked for every row of the block
    for j in set(range(-(-T // bkv))) - set(got):
        for qi in (q0, q_last):
            for ki in range(j * bkv, min((j + 1) * bkv, T)):
                assert ((causal and ki > qi)
                        or (window > 0 and qi - ki >= window))


def _qkv(seed, B, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, hd), (B, S, Hkv, hd),
                               (B, S, Hkv, hd)))


# (B, S, H, Hkv, hd, window, softcap, causal); at these head dims the plan
# has 128 or 256 query rows a block and 32 or 64 keys a tile
MODEL_CASES = {
    "ragged": (2, 300, 4, 2, 128, 0, 0.0, True),
    "window-under-a-tile": (1, 300, 4, 1, 64, 16, 0.0, True),
    "softcap": (1, 256, 4, 4, 128, 0, 50.0, True),
    "non-causal": (1, 200, 6, 2, 80, 0, 0.0, False),
    "non-causal-window": (1, 150, 2, 1, 256, 40, 30.0, False),
    "hd-100": (2, 200, 4, 1, 100, 128, 30.0, True),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_fp32_model_matches_plain_and_reference(case):
    B, S, H, Hkv, hd, window, cap, causal = MODEL_CASES[case]
    q, k, v = _qkv(S + H + hd, B, S, H, Hkv, hd)
    scale = 1.0 / hd ** 0.5
    # as the wrapper pads: zero columns up to a multiple of 8, the scale of
    # the real head dim
    pad = (0, -hd % 8)
    qt, kt, vt = (torch.nn.functional.pad(torch.from_numpy(a), pad)
                  for a in (q, k, v))
    kw = dict(causal=causal, window=window, softcap=cap, scale=scale)
    got = fa.flash_attention_fp32_model(qt, kt, vt, **kw)[..., :hd]
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    plain = fa.flash_attention_plain(qt, kt, vt, **kw)[..., :hd]
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL,
                               rtol=RTOL)
    want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal, window=window or None,
                                softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_fp32_model_rows_masked_in_a_whole_tile_stay_finite():
    """A window narrower than a tile: in the block's first tile most rows
    have no real score, so m stays at the finite NEG_INF and p = 2^0 = 1,
    wiped by a rescale of 0 at the row's first real score.  Kept in
    log2 units with NEG_INF itself scaled by log2 e, m would be -inf and
    p = 2^(-inf - -inf) NaN."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 1, 256, 2, 1, 64))
    kw = dict(causal=True, window=8, softcap=0.0, scale=0.125)
    got = fa.flash_attention_fp32_model(q, k, v, **kw)
    assert bool(torch.isfinite(got).all())
    with np.errstate(over="ignore"):
        assert np.float32(fa.NEG_INF) * np.float32(fa.LOG2E) == -np.inf
    np.testing.assert_allclose(
        got.numpy(), fa.flash_attention_plain(q, k, v, **kw).numpy(),
        atol=ATOL, rtol=RTOL)
