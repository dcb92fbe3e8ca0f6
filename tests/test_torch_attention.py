"""The port's attention against the reference's, on the CPU.

`repro_torch.kernels.ops.flash_attention` on CPU tensors runs the
kernel's plain version; it is held against the reference's
`repro.kernels.ops.flash_attention` (the Pallas kernel in interpret mode)
on the grid of tests/test_kernels.py, fp32 at 2e-5 and bf16 at 2e-2 (the
tolerances of that file), plus hd=120 with a window and hd=12 and 100,
which the wrapper zero-pads to a multiple of 8.  At these sizes the
reference runs one 512-wide kv tile, so the cases where whole kv tiles
are masked are checked on the card (chip_smoke.py phase 8).

One attention layer of the gemma2 smoke config (attn_local, softcap 50)
is then held against the reference's `attention.run` on both paths:
impl="kernel" against "pallas" and impl="einsum" against "xla".  The
math is the same on both sides, so 2e-2 (one layer, bf16 activations).
Inputs come from a numpy seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import attention as jattention
from repro.models import transformer as jtransformer
from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.models import transformer

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _qkv(seed, B, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, hd), (B, S, Hkv, hd),
                               (B, S, Hkv, hd)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,H,Hkv,hd,window,cap,causal", [
    (512, 4, 2, 64, 0, 0.0, True),
    (512, 4, 4, 128, 0, 50.0, True),
    (1024, 8, 1, 64, 256, 0.0, True),
    (512, 6, 2, 80, 0, 0.0, True),       # hd not a power of two
    (512, 4, 2, 120, 64, 0.0, True),     # danube's hd, with a window
    (256, 4, 2, 32, 0, 0.0, False),      # no mask at all
    (256, 4, 2, 12, 0, 0.0, True),       # hd not a multiple of 8: padded
    (512, 4, 1, 100, 128, 30.0, True),   # padded, window and softcap
])
def test_flash_attention_matches_reference(S, H, Hkv, hd, window, cap,
                                           causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv(S + H + hd, 2, S, H, Hkv, hd)
    want = jops.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                causal=causal, window=window or None,
                                softcap=cap)
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)),
                              causal=causal, window=window, softcap=cap)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(_as_f32(got), _as_f32(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("impl,jimpl", [("kernel", "pallas"),
                                        ("einsum", "xla")])
def test_attention_layer_matches_reference(impl, jimpl):
    jcfg = jconfigs.get("gemma2_27b", smoke=True)
    cfg = configs.get("gemma2_27b", smoke=True)
    params = jtransformer.init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    model = transformer.Transformer(cfg, generator=torch.Generator(),
                                    device=torch.device("cpu"))
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    layer = jax.tree.map(lambda leaf: leaf[0], params["groups"][0])
    attn = model.blocks[0].attn
    assert attn.kind == "attn_local"

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 256, cfg.d_model)) * 0.3).astype(np.float32)
    want, _ = jattention.run(layer["attn"], jnp.asarray(x, jnp.bfloat16),
                             jnp.arange(256)[None, :], jcfg,
                             kind="attn_local", mode="train", impl=jimpl)
    with torch.no_grad():
        got, _ = attn(torch.from_numpy(x).to(torch.bfloat16),
                      torch.arange(256)[None, :], mode="train", impl=impl)
    np.testing.assert_allclose(_as_f32(got), _as_f32(want), atol=2e-2,
                               rtol=2e-2)


def _operands(**over):
    shapes = dict(q=(1, 16, 4, 16), k=(1, 16, 2, 16), v=(1, 16, 2, 16))
    args = {name: torch.zeros(shape) for name, shape in shapes.items()}
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(q=torch.zeros(1, 16, 4, 16, dtype=torch.float64)), "float32"),
    (dict(q=torch.zeros(1, 16, 4, 16, dtype=torch.bfloat16)), "one dtype"),
    (dict(k=torch.zeros(1, 16, 16, 2).transpose(2, 3)), "contiguous"),
    (dict(q=torch.zeros(1, 16, 3, 16)), "divide"),
    (dict(v=torch.zeros(1, 8, 2, 16)), r"k and v must be"),
    (dict(q=torch.zeros(1, 16, 4, 264), k=torch.zeros(1, 16, 2, 264),
          v=torch.zeros(1, 16, 2, 264)), "up to 256"),
    (dict(q=torch.zeros(16, 4, 16)), "4-D"),
])
def test_flash_attention_wrapper_checks_operands(over, match):
    args = _operands(**over)
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(args["q"], args["k"], args["v"])


def test_flash_attention_cpu_never_counts_a_launch():
    before = ops.FLASH_ATTENTION_LAUNCHES
    args = _operands()
    out = ops.flash_attention(args["q"], args["k"], args["v"], window=4)
    assert out.shape == (1, 16, 4, 16)
    assert ops.FLASH_ATTENTION_LAUNCHES == before
