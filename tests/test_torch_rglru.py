"""The port's RG-LRU scan and recurrent layer against the reference's, on
the CPU.

`repro_torch.kernels.ops.rglru` on CPU tensors runs the kernel's plain
version, a sequential fp32 loop with each product and sum rounded.  It is
held against the reference's `repro.kernels.ops.rglru` (the Pallas kernel
in interpret mode, the same loop) on the grid of tests/test_kernels.py,
with and without h0, to 1e-6.  Not bitwise: XLA's CPU compiler contracts
the interpret-mode kernel's a*h + b into a fused multiply-add (a numpy
loop that rounds a*h + b once reproduces it bitwise), where the port
rounds the product first, as its CUDA kernel does; the port is bitwise
equal to a numpy loop of separate roundings instead.  It is also held
against the reference's oracle `ref.rglru_ref`, an associative scan
that sums in another order, to 1e-5 as tests/test_kernels.py holds the
kernel.  R = 200 is not a multiple of the Pallas kernel's 128 lanes, so
there the oracle and a numpy loop stand in for it; so at the card's ring
edges (S = 1, odd S and R, R < 32).  The CUDA kernel's stage length, which
the wrapper picks from the card's limits, is checked against an H100's.

One recurrent layer of the recurrentgemma smoke config (weights from the
reference's `init_params`) is then held against the reference's
`rglru.run` in modes train, prefill and decode, on both of the port's
impls.  impl="einsum" runs the reference's associative scan in its order;
impl="kernel" the sequential scan, whose state differs by fp32 ulps.
bf16 activations: outputs within 2e-2 (one layer, as
tests/test_torch_attention.py), the fp32 state within 1e-5 and the conv
history exactly.  Inputs come from a numpy seed; the reference is
compiled with XLA's excess precision off (tests/test_torch_model.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rglru as jrglru
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.kernels.rglru_scan import rglru_scan_plain
from repro_torch.models import rglru

STRICT = {"xla_allow_excess_precision": False}
GRID = [(b, s, r) for b in (1, 2, 3) for s in (64, 256)
        for r in (128, 256, 384)]
LAYER_TOL = 2e-2
STATE_TOL = 1e-5


def _inputs(seed, B, S, R):
    """a in (0, 1) (a sigmoid of a normal, as the model's gates make it),
    b and h0 normal, float32."""
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal((B, S, R))))
    return (a.astype(np.float32),
            rng.standard_normal((B, S, R)).astype(np.float32),
            rng.standard_normal((B, R)).astype(np.float32))


def _loop(a, b, h0):
    """The recurrence in numpy fp32, one rounding an op."""
    h = np.zeros_like(a)
    hc = h0.copy()
    for t in range(a.shape[1]):
        hc = a[:, t] * hc + b[:, t]
        h[:, t] = hc
    return h


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("B,S,R", GRID)
def test_scan_matches_pallas_kernel(B, S, R, with_h0):
    a, b, h0 = _inputs(B * 100 + S + R, B, S, R)
    j0 = jnp.asarray(h0) if with_h0 else None
    want, want_last = jops.rglru(jnp.asarray(a), jnp.asarray(b), j0)
    got, got_last = rglru_scan_plain(
        torch.from_numpy(a), torch.from_numpy(b),
        torch.from_numpy(h0) if with_h0 else None)
    assert got.shape == (B, S, R) and got_last.shape == (B, R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               atol=1e-6, rtol=1e-6)
    # each product and sum rounded: bitwise the numpy loop
    np.testing.assert_array_equal(
        got.numpy(), _loop(a, b, h0 if with_h0 else np.zeros_like(h0)))
    np.testing.assert_array_equal(got_last.numpy(), got.numpy()[:, -1])


# the card's ring edges (chip_smoke.py phase 16): S = 1, S and R odd,
# R < 32, and the serving R at a short S
RING_EDGES = [(1, 1, 7), (2, 97, 202), (1, 33, 2560)]


@pytest.mark.parametrize("B,S,R", GRID + [(2, 64, 200), (3, 256, 200)]
                         + RING_EDGES)
def test_scan_matches_reference_oracle(B, S, R):
    a, b, h0 = _inputs(B + S + R, B, S, R)
    want = np.asarray(jref.rglru_ref(jnp.asarray(a), jnp.asarray(b)))
    got, got_last = ops.rglru(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_last.numpy(), want[:, -1], atol=1e-5,
                               rtol=1e-5)
    # with h0, against the numpy loop in the same order: bitwise
    got, got_last = ops.rglru(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(h0))
    np.testing.assert_array_equal(got.numpy(), _loop(a, b, h0))
    np.testing.assert_array_equal(got_last.numpy(), got.numpy()[:, -1])


# an H100 SXM's limits as rglru_scan_limits reads them: SMs, shared bytes
# an SM, bytes a block may ask for, bytes reserved a block
H100 = (132, 233472, 232448, 1024)


@pytest.mark.parametrize("B,S,R", [(4, 4096, 2560), (2, 4096, 2560),
                                   (1, 4096, 2560), (2, 1, 2560),
                                   (2, 4097, 2560), (3, 100, 7),
                                   (65600, 8, 16), (64, 4096, 2560)])
def test_scan_stage_length_fills_the_card(B, S, R):
    steps = ops.scan_steps(B, S, R, *H100)
    sms, smem_sm, smem_block, reserved = H100
    groups = B * -(-R // ops.SCAN_GROUP)
    assert steps >= 8 and steps % 8 == 0
    assert steps <= max(8, -(-S // 8) * 8)
    ring = ops.scan_ring_bytes(steps)
    assert ring <= smem_block
    if groups <= 32 * sms and steps > 8:
        # every group resident at once
        per_sm = -(-groups // sms)
        assert per_sm * (ring + reserved) <= smem_sm
    # about SCAN_IN_FLIGHT bytes of a and b in flight, never past it
    # unless the shortest stage does
    in_flight = groups * (ops.SCAN_STAGES - 1) * steps * 2 * 32 * 4
    assert in_flight <= ops.SCAN_IN_FLIGHT or steps == 8


def test_scan_stage_length_at_the_serving_shapes():
    # recurrentgemma-2b's prefill: 320 groups, 12 KB in flight a group
    assert ops.scan_steps(4, 4096, 2560, *H100) == 16
    assert ops.scan_ring_bytes(16) == 16384
    # B = 1: 80 groups, each with more in flight
    assert ops.scan_steps(1, 4096, 2560, *H100) == 64
    # a short S takes a short stage
    assert ops.scan_steps(2, 1, 2560, *H100) == 8


def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing():
    a, b, h0 = (torch.from_numpy(x) for x in _inputs(0, 2, 16, 40))
    before = ops.RGLRU_SCAN_LAUNCHES
    h, h_last = ops.rglru(a, b, h0)
    p, p_last = rglru_scan_plain(a, b, h0)
    assert torch.equal(h, p) and torch.equal(h_last, p_last)
    assert ops.RGLRU_SCAN_LAUNCHES == before
    # zero steps: h_last is h0 (zeros without one)
    h, h_last = ops.rglru(a[:, :0], b[:, :0], h0)
    assert h.shape == (2, 0, 40) and torch.equal(h_last, h0)
    assert not ops.rglru(a[:, :0], b[:, :0])[1].any()


def test_wrapper_checks_operands():
    a, b, h0 = (torch.from_numpy(x) for x in _inputs(1, 2, 8, 24))
    with pytest.raises(ValueError, match="float32"):
        ops.rglru(a.double(), b)
    with pytest.raises(ValueError, match="float32"):
        ops.rglru(a, b, h0.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru(a.transpose(1, 2), b.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru(a, b, torch.zeros(24, 2).t())
    with pytest.raises(ValueError, match="shape"):
        ops.rglru(a, b[:, :-1].contiguous())
    with pytest.raises(ValueError, match="h0"):
        ops.rglru(a, b, h0[:1])
    with pytest.raises(ValueError, match="h0"):
        ops.rglru(a, b, torch.zeros(2, 23))


# ---------------------------------------------------------------------------
# one recurrent layer against the reference's rglru.run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer():
    """The reference's layer-0 recurrent weights (recurrentgemma smoke)
    and the port's RGLRU holding them."""
    jcfg = jconfigs.get("recurrentgemma_2b", smoke=True)
    cfg = configs.get("recurrentgemma_2b", smoke=True)
    params = jtransformer.init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    jp = jax.tree.map(lambda l: l[0], params["groups"][0]["rec"])
    mod = rglru.RGLRU(cfg, generator=torch.Generator(),
                      device=torch.device("cpu"))
    mod.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in jp.items()})
    return jcfg, jp, mod


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


def _x(seed, B, S, D):
    x = np.random.default_rng(seed).standard_normal((B, S, D)) * 0.5
    return x.astype(np.float32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_layer_matches_reference(layer, mode, impl):
    jcfg, jp, mod = layer
    x = _x(7, 2, 48, jcfg.d_model)
    want, wcache = _strict(lambda p, x: jrglru.run(
        p, x, jcfg, mode=mode), jp, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got, cache = mod(torch.from_numpy(x).bfloat16(), mode=mode,
                         impl=impl)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=LAYER_TOL,
                               rtol=LAYER_TOL)
    if mode == "train":
        assert cache is None and wcache is None
        return
    assert cache["h"].dtype == cache["conv"].dtype == torch.float32
    np.testing.assert_allclose(cache["h"].numpy(), _f32(wcache["h"]),
                               atol=STATE_TOL, rtol=STATE_TOL)
    np.testing.assert_array_equal(cache["conv"].numpy(), _f32(wcache["conv"]))


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_layer_decode_matches_reference(layer, impl):
    """Prefill 20 tokens, then 4 decode steps from the reference's own
    caches: each step's output and new state on both sides."""
    jcfg, jp, mod = layer
    x = _x(11, 2, 24, jcfg.d_model)
    xb = jnp.asarray(x, jnp.bfloat16)
    _, jcache = _strict(lambda p, x: jrglru.run(p, x, jcfg, mode="prefill"),
                        jp, xb[:, :20])
    step = jax.jit(lambda p, x, c: jrglru.run(
        p, x, jcfg, mode="decode", cache=c)).lower(
            jp, xb[:, :1], jcache).compile(compiler_options=STRICT)
    cache = {k: torch.tensor(_f32(v)) for k, v in jcache.items()}
    with torch.no_grad():
        for t in range(20, 24):
            want, jcache = step(jp, xb[:, t:t + 1], jcache)
            got, cache = mod(torch.from_numpy(x[:, t:t + 1]).bfloat16(),
                             mode="decode", cache=cache, impl=impl)
            np.testing.assert_allclose(_f32(got), _f32(want),
                                       atol=LAYER_TOL, rtol=LAYER_TOL)
            np.testing.assert_allclose(cache["h"].numpy(), _f32(jcache["h"]),
                                       atol=STATE_TOL, rtol=STATE_TOL)
            np.testing.assert_array_equal(cache["conv"].numpy(),
                                          _f32(jcache["conv"]))


def test_layer_kernel_path_goes_through_the_wrapper(layer, monkeypatch):
    """impl="kernel" hands the scan to kernels.ops.rglru (once a call),
    impl="einsum" and decode never do."""
    jcfg, _, mod = layer
    calls = []
    real = ops.rglru

    def spy(a, b, h0=None):
        calls.append(a.shape)
        return real(a, b, h0)
    monkeypatch.setattr(ops, "rglru", spy)
    x = torch.from_numpy(_x(3, 2, 16, jcfg.d_model)).bfloat16()
    with torch.no_grad():
        _, cache = mod(x, mode="prefill", impl="kernel")
        assert calls == [(2, 16, jcfg.d_model)]
        mod(x, mode="train", impl="einsum")
        mod(x[:, :1], mode="decode", cache=cache, impl="kernel")
    assert len(calls) == 1
