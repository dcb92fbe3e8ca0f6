"""The bf16 attention kernel's tile plan against the card's limits, on the CPU.

`repro_torch.kernels.flash_attention.tile_plan` is the one copy of the
wgmma / TMA kernel's tiling (kernels/csrc/flash_attention.cu): the wrapper
passes it to the kernel's entry, which launches the template built for it
or refuses.  Nothing here runs the kernel; it holds every plan the
wrapper can ask for (a head dim that is a multiple of 8 up to 256) to what
an H100 takes: at most 232,448 bytes of shared memory a block, a TMA box
whose inner extent is at most the 128-byte swizzle's row, wgmma N a
multiple of 8 up to 256, BKV a multiple of the k16 step, and a template
that the source builds.  It also checks that the plan covers every head
dim of chip_smoke.py's attention cases and of the ten configs.
"""
import re

import pytest
import torch

import chip_smoke
from repro_torch import configs
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa

SMEM_BLOCK_MAX = 232_448
HEAD_DIMS = list(range(8, 257, 8))


def _built_templates() -> set:
    """(HDP, BKV, STAGES) of FA_WGMMA_TEMPLATES in the kernel's source."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    line = re.search(r"#define FA_WGMMA_TEMPLATES\(X\)(.*)", src)
    assert line, "no FA_WGMMA_TEMPLATES line in flash_attention.cu"
    return {tuple(int(x) for x in m) for m in
            re.findall(r"X\((\d+), (\d+), (\d+)\)", line.group(1))}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plan_fits_the_card(hd):
    p = fa.tile_plan(hd)
    assert hd <= p.hdp <= 256 and p.hdp % fa.ATOM == 0
    assert p.smem <= SMEM_BLOCK_MAX
    # Q, the K and V rings, the barriers, and the base's alignment slack
    assert p.smem == (1024 + 2 * (p.bq * p.hdp + 2 * p.stages * p.bkv * p.hdp)
                      + 8 * (2 + 4 * p.stages))
    for box in (p.box_q, p.box_kv):
        assert len(box) == 4 and all(1 <= b <= 256 for b in box)
        assert box[0] * 2 <= fa.SWIZZLE_BYTES and box[0] * 2 % 16 == 0
    assert p.box_q[2] == p.bq and p.box_kv[2] == p.bkv
    for n in (p.bkv, fa.ATOM):     # the N of S = Q K^T and of O += P V
        assert n % 8 == 0 and 8 <= n <= 256
    assert p.bkv % 16 == 0 and p.hdp % fa.ATOM == 0
    assert p.bq == fa.CONSUMERS * fa.WGMMA_M
    assert p.stages >= 2


def test_every_plan_is_a_built_template():
    built = _built_templates()
    plans = {(p.hdp, p.bkv, p.stages) for p in map(fa.tile_plan, HEAD_DIMS)}
    assert plans <= built, f"plans {plans - built} are not built"
    assert 3 <= len(built) <= 4


def test_plan_covers_the_cases_and_the_configs():
    hds = {-(-c[5] // 8) * 8 for c in chip_smoke.FA_CASES}
    for arch in configs.all_archs():
        for smoke in (False, True):
            cfg = configs.get(arch, smoke=smoke)
            if any(b.startswith("attn") for b in cfg.block_pattern):
                hds.add(-(-cfg.head_dim // 8) * 8)
    assert {128, 120, 256, 64, 80, 104, 32, 16} <= hds
    for hd in sorted(hds):
        p = fa.tile_plan(hd)
        assert p.hdp >= hd and p.smem <= SMEM_BLOCK_MAX


@pytest.mark.parametrize("hd", [0, 4, 12, 260, 264, 512])
def test_plan_refuses_other_head_dims(hd):
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.tile_plan(hd)


def test_tiles_tool_rewrites_one_template():
    import sys
    sys.path.insert(0, str(build.CSRC.parents[3] / "tools"))
    import attention_tiles
    src = (build.CSRC / "flash_attention.cu").read_text()
    own = fa.tile_plan(128)
    out = attention_tiles.variant_source(src, 128, 64, 3)
    assert _built_templates() - {(128, own.bkv, own.stages)} | {
        (128, 64, 3)} == {
        tuple(int(x) for x in m) for m in re.findall(
            r"X\((\d+), (\d+), (\d+)\)",
            re.search(r"#define FA_WGMMA_TEMPLATES\(X\)(.*)", out).group(1))}
    with pytest.raises(SystemExit, match="no hd-96 entry"):
        attention_tiles.variant_source(src, 96, 64, 2)
