"""The port's xLSTM blocks against the reference's, on the CPU.

`xlstm.mlstm_chunk`, one chunk of the stabilised chunkwise mLSTM, is held
to the reference's `_mlstm_chunk` on fp32 inputs (a numpy seed), from a
fresh state (m = -1e30) and from a carried one, within 1e-5 of each
output's scale: both run every step in fp32 and differ only in the
order of the sums inside the products.

The mLSTM and sLSTM blocks of the xlstm smoke config (layers 0 and 3;
weights from the reference's `init_params(PRNGKey(0))`) then run the
same bf16 input in modes train and prefill, at S = 512 for the mLSTM
(two chunks of 256, so the state crosses a chunk boundary) and S = 64
for the sLSTM, then decode steps from the prefill's cache.  Outputs
within 2e-2 (bf16 activations, one layer), the fp32 states within 2e-2
of their scale, the conv history bitwise.  The reference is compiled
with XLA's excess precision off (tests/test_torch_model.py).

The group norm uses the population variance, as the reference's
`jnp.var`; the sample variance (unbiased=True) must fail the same check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.models import xlstm as jxlstm
from repro_torch import configs, convert
from repro_torch.models import transformer, xlstm

STRICT = {"xla_allow_excess_precision": False}
CPU = torch.device("cpu")
CHUNK_RTOL = 1e-5
LAYER_TOL = 2e-2
NORM_TOL = 1e-6
ARCH = "xlstm_1_3b"


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close_to_scale(got, want, rtol, what):
    """|got - want| within rtol of want's largest magnitude."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol} * {scale:.3e}"


def _chunk_inputs(seed, B=2, H=2, L=64, hd=32, carried=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, L, hd)).astype(np.float32)
               for _ in range(3))
    logf = -np.log1p(np.exp(-rng.standard_normal((B, H, L)) - 2.0))
    logi = rng.standard_normal((B, H, L))
    if carried:
        state = (rng.standard_normal((B, H, hd, hd)),
                 rng.standard_normal((B, H, hd)),
                 rng.standard_normal((B, H)))
    else:
        state = (np.zeros((B, H, hd, hd)), np.zeros((B, H, hd)),
                 np.full((B, H), -1e30))
    return [a.astype(np.float32) for a in
            (q, k, v, logf, logi, *state)]


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_mlstm_chunk_matches_reference(carried):
    args = _chunk_inputs(1 + carried, carried=carried)
    want_h, want_state = _strict(
        lambda q, k, v, f, i, S, n, m: jxlstm._mlstm_chunk(
            q, k, v, f, i, (S, n, m)), *map(jnp.asarray, args))
    t = [torch.from_numpy(a) for a in args]
    got_h, got_state = xlstm.mlstm_chunk(*t[:5], tuple(t[5:]))
    _close_to_scale(got_h, want_h, CHUNK_RTOL, "h")
    for name, g, w in zip("Snm", got_state, want_state):
        _close_to_scale(g, w, CHUNK_RTOL, name)


@pytest.fixture(scope="module")
def blocks():
    """(reference config, reference params of layers 0 (mLSTM) and 3
    (sLSTM), the port's blocks 0 and 3) on the same weights."""
    jcfg = jconfigs.get(ARCH, smoke=True)
    cfg = configs.get(ARCH, smoke=True)
    tree = jax.tree.map(np.asarray, jtransformer.init_params(
        jcfg, jax.random.PRNGKey(0), tp=1))
    model = transformer.Transformer(cfg, generator=torch.Generator(),
                                    device=CPU)
    model.load_state_dict(convert.params_from_numpy(cfg, tree))
    params = {i: jax.tree.map(lambda a: jnp.asarray(a[0]),
                              tree["groups"][i]["cell"]) for i in (0, 3)}
    return jcfg, params, {i: model.blocks[i].cell for i in (0, 3)}


def _x(seed, S, d, B=2):
    x = np.random.default_rng(seed).standard_normal((B, S, d))
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _jx(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def _reference_run(jcfg, layer, p, x, mode, cache=None):
    run = jxlstm.run_mlstm if layer == 0 else jxlstm.run_slstm
    return _strict(lambda p, x, c: run(p, x, jcfg, mode=mode, cache=c),
                   p, _jx(x), cache)


def _assert_cache(got, want):
    assert set(got) == set(want)
    for name in got:
        assert got[name].dtype == torch.float32, name
        if name == "conv":
            np.testing.assert_array_equal(_f32(got[name]), _f32(want[name]))
        else:
            _close_to_scale(got[name], want[name], LAYER_TOL, name)


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("layer,S", [(0, 512), (3, 64)],
                         ids=["mlstm", "slstm"])
def test_block_matches_reference(blocks, layer, S, mode):
    jcfg, params, port = blocks
    x = _x(10 + layer, S, jcfg.d_model)
    want, want_cache = _reference_run(jcfg, layer, params[layer], x, mode)
    with torch.no_grad():
        got, got_cache = port[layer](x, mode=mode)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=LAYER_TOL,
                               rtol=0)
    if mode == "train":
        assert got_cache is None
    else:
        _assert_cache(got_cache, want_cache)


@pytest.mark.parametrize("layer,S", [(0, 512), (3, 64)],
                         ids=["mlstm", "slstm"])
def test_block_decode_matches_reference(blocks, layer, S):
    """Four decode steps from the prefill's cache, each a fresh token."""
    jcfg, params, port = blocks
    x = _x(20 + layer, S + 4, jcfg.d_model)
    _, jc = _reference_run(jcfg, layer, params[layer], x[:, :S], "prefill")
    with torch.no_grad():
        _, tc = port[layer](x[:, :S], mode="prefill")
        for t in range(S, S + 4):
            want, jc = _reference_run(jcfg, layer, params[layer],
                                      x[:, t:t + 1], "decode", jc)
            got, tc = port[layer](x[:, t:t + 1], mode="decode", cache=tc)
            np.testing.assert_allclose(_f32(got), _f32(want),
                                       atol=LAYER_TOL, rtol=0, err_msg=t)
    _assert_cache(tc, jc)


def test_mlstm_rejects_a_sequence_off_the_chunk(blocks):
    """S = 300 is no multiple of the 256-step chunk (the reference
    asserts the same)."""
    _, _, port = blocks
    with pytest.raises(ValueError, match="chunk"):
        port[0](_x(30, 300, 64), mode="train")


def _group_norm_sample_variance(x, w, eps=1e-6):
    """A wrong group norm: the sample variance (unbiased=True)."""
    xf = x.float()
    xn = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
        xf.var(-1, keepdim=True, unbiased=True) + eps)
    B, S, H, hd = x.shape
    return (xn.reshape(B, S, H * hd) * (1.0 + w.float())).to(x.dtype)


def test_group_norm_uses_population_variance():
    rng = np.random.default_rng(40)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = _f32(_strict(lambda x, w: jxlstm._group_norm(x, w, 4),
                        jnp.asarray(x), jnp.asarray(w)))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(_f32(xlstm.group_norm(tx, tw)), want,
                               atol=NORM_TOL, rtol=NORM_TOL)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_f32(_group_norm_sample_variance(tx, tw)),
                                   want, atol=NORM_TOL, rtol=NORM_TOL)


def test_caches_match_reference_shapes():
    jcfg = jconfigs.get(ARCH)
    cfg = configs.get(ARCH)
    for port_fn, ref_fn in ((xlstm.make_mlstm_cache, jxlstm.make_mlstm_cache),
                            (xlstm.make_slstm_cache, jxlstm.make_slstm_cache)):
        got = port_fn(cfg, 4, device=torch.device("meta"))
        want = ref_fn(jcfg, 4, shapes_only=True)
        assert set(got) == set(want)
        for name in got:
            assert tuple(got[name].shape) == want[name].shape, name
            assert got[name].dtype == torch.float32
    # the mLSTM head dim is 2 d / H = 1024 at xlstm-1.3b, not head_dim 512
    assert tuple(xlstm.make_mlstm_cache(
        cfg, 1, device=torch.device("meta"))["S"].shape) == (1, 4, 1024, 1024)
