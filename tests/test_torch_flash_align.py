"""The attention wrapper's alignment copy (kernels/ops.py::_aligned16).

The attention kernel's TMA maps and 16-byte copies need q, k and v to
start on a 16-byte boundary.  A contiguous view into a larger tensor may
start elsewhere; the wrapper hands the kernel a fresh copy of such an
operand instead of refusing it.  The copy is checked here on CPU tensors
(the kernel itself runs only on the card: chip_smoke.py phase 8 holds a
misaligned call bitwise to the aligned one there).
"""
import pytest
import torch

from repro_torch.kernels import ops

# (B, S, H, hd) of q; k and v take 2 heads (GQA)
SHAPE = (2, 48, 4, 64)


def _draw(shape, dtype, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def _misaligned(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of `t` that starts `offset` bytes past a 16-byte
    boundary."""
    size = t.element_size()
    flat = torch.empty(t.numel() + 32 // size, dtype=t.dtype)
    skip = (offset - flat.data_ptr()) % 16 // size
    view = flat[skip:skip + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset
    return view


@pytest.mark.parametrize("dtype,offset", [
    (torch.float32, 4), (torch.float32, 8), (torch.float32, 12),
    (torch.bfloat16, 2), (torch.bfloat16, 4), (torch.bfloat16, 14)])
def test_a_misaligned_view_comes_back_as_an_aligned_copy(dtype, offset):
    view = _misaligned(_draw(SHAPE, dtype, offset), offset)
    got = ops._aligned16(view)
    assert got.data_ptr() % 16 == 0
    assert got.data_ptr() != view.data_ptr()
    assert got.is_contiguous()
    assert got.dtype == view.dtype and got.shape == view.shape
    assert torch.equal(got, view)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_an_aligned_tensor_comes_back_as_itself(dtype):
    for t in (_draw(SHAPE, dtype, 0), _misaligned(_draw(SHAPE, dtype, 1), 0)):
        assert t.data_ptr() % 16 == 0
        assert ops._aligned16(t) is t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_misaligned_operands_attend_as_their_aligned_copies(dtype):
    """On the CPU the wrapper runs the plain version: misaligned views of
    q, k and v give the output of their aligned copies, bit for bit."""
    kv = SHAPE[:2] + (2,) + SHAPE[3:]
    q, k, v = (_draw(SHAPE, dtype, 2), _draw(kv, dtype, 3),
               _draw(kv, dtype, 4))
    views = [_misaligned(t, off) for t, off in ((q, 4), (k, 8), (v, 12))]
    got = ops.flash_attention(*views, causal=True)
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=True))
