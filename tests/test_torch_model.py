"""The port's models against the reference's, on the CPU.

For the smoke configs of all ten architectures (the dense phi4-mini,
nemotron, gemma2 and h2o-danube; the MoE granite-moe and qwen2-moe;
recurrentgemma, two RG-LRU layers and a windowed attention layer; xlstm,
three mLSTM layers and an sLSTM layer; the encoder-decoder seamless; the
VLM internvl2), the reference's `init_params(PRNGKey(0))` goes through
`convert.params_from_numpy` into the port, and both run the same inputs
(numpy seeds: tokens, and the encoder's frame embeddings or the VLM's
image embeddings): the teacher-forced forward, the prefill (the port's
impl="kernel" against the reference's impl="pallas": last-token logits
and every layer's cache), then 8 decode steps fed the same token ids
(the encoder's memory passed to each; a VLM's positions offset by its
image tokens).  Logits agree to 2e-2 absolute, as in
tests/test_decode_consistency.py.  The recurrent layers' scan is
sequential in the port's kernel path and associative in the reference's
model, so their states differ by fp32 ulps; the same 2e-2 holds them,
and the xLSTM states.

The reference is compiled with XLA's `xla_allow_excess_precision` off.
With it on (XLA's default), the CPU fusions keep some bf16 intermediates
in fp32, and the smoke models' random weights turn such a last-place
difference into logit differences of 0.1 to 1: the reference run that
way disagrees by that much with itself run op by op.  With it off, each
bf16 op rounds as written, which is what the port computes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.runtime import sharding, steps

ARCHS = ("phi4_mini_3_8b", "nemotron_4_15b", "gemma2_27b",
         "h2o_danube_3_4b", "recurrentgemma_2b", "granite_moe_1b_a400m",
         "qwen2_moe_a2_7b", "seamless_m4t_large_v2", "internvl2_1b",
         "xlstm_1_3b")
# the architectures this file's tests added when their models were ported
NEW_ARCHS = ARCHS[5:]
# an encoder-decoder model's frames (the serve CLI draws 32)
ENC = 12
B, S, GEN = 2, 16, 8
TOL = 2e-2
# the summed aux loss: router softmaxes of hidden states that differ by
# bf16 places between the packages
AUX_RTOL = 1e-3
CPU = torch.device("cpu")
# every bf16 op of the reference rounded as written (see the docstring)
STRICT = {"xla_allow_excess_precision": False}


def _strict(fn, *args):
    """Compile fn for args with STRICT, and run it."""
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


def _as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _models(jcfg, cfg, seed=0):
    params = jtransformer.init_params(jcfg, jax.random.PRNGKey(seed), tp=1)
    model = transformer.Transformer(cfg, generator=torch.Generator(),
                                    device=CPU)
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return params, model


def _jax_layer_caches(jcfg, caches):
    """The reference's stacked caches as one dict a layer: {"k", "v",
    "len"} for attention, the state and conv history for a recurrent or
    xLSTM layer."""
    P = len(jcfg.block_pattern)
    n_groups = jcfg.n_layers // P
    out = [None] * jcfg.n_layers
    for i, slot in enumerate(caches["groups"]):
        (_, c), = slot.items()
        for g in range(n_groups):
            out[g * P + i] = {name: leaf[g] for name, leaf in c.items()}
    for i, layer in enumerate(caches["rem"]):
        (_, c), = layer.items()
        out[n_groups * P + i] = c
    return out


def _extras(cfg, seed):
    """The stub frontends' inputs, fp32 numpy: frame embeddings (B, ENC,
    d) for an encoder-decoder model, image embeddings (B, n_img, d) for
    a VLM."""
    rng = np.random.default_rng(seed + 1000)
    out = {}
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.standard_normal((B, ENC, cfg.d_model))
    if cfg.family == "vlm":
        out["img_embeds"] = rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _run_both(arch, prompt, gen, seed):
    """Both packages on the same weights and inputs: teacher-forced
    logits and aux, prefill logits and caches, and `gen` decode steps'
    logits and the caches after them."""
    jcfg = jconfigs.get(arch, smoke=True)
    cfg = configs.get(arch, smoke=True)
    params, model = _models(jcfg, cfg)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (B, prompt + gen))
    extras = _extras(cfg, seed)
    jx = {k: jnp.asarray(v) for k, v in extras.items()}
    tx = {k: torch.from_numpy(v) for k, v in extras.items()}
    pos0 = prompt + (cfg.n_img_tokens if cfg.family == "vlm" else 0)
    max_len = pos0 + gen
    out = {"jax": {}, "port": {}}
    j = out["jax"]
    j["train"], j["aux"] = _strict(lambda p, t, x: jtransformer.train_logits(
        jcfg, p, {"tokens": t, **x}, remat=False), params,
        jnp.asarray(toks), jx)
    j["prefill"], caches = _strict(lambda p, t, x: jtransformer.prefill(
        jcfg, p, {"tokens": t, **x}, impl="pallas", max_len=max_len),
        params, jnp.asarray(toks[:, :prompt]), jx)
    j["prefill_cache"] = _jax_layer_caches(jcfg, caches)
    memory = None
    if cfg.family == "encdec":
        memory = _strict(lambda p, e: jtransformer._encode(jcfg, p, e),
                         params, jx["enc_embeds"])
    step = jax.jit(lambda p, c, t, pos, m: jtransformer.decode_step(
        jcfg, p, c, t, pos, memory=m)).lower(
            params, caches, jnp.asarray(toks[:, :1]), jnp.asarray(pos0),
            memory).compile(compiler_options=STRICT)
    j["decode"] = []
    for i in range(gen):
        logits, caches = step(params, caches,
                              jnp.asarray(toks[:, prompt + i:prompt + i + 1]),
                              jnp.asarray(pos0 + i), memory)
        j["decode"].append(logits)
    j["decode_cache"] = _jax_layer_caches(jcfg, caches)
    t = out["port"]
    prefill = steps.make_prefill_step(cfg, impl="kernel", max_len=max_len)
    decode = steps.make_decode_step(cfg, impl="kernel")
    memory = None
    with torch.no_grad():
        t["train"], t["aux"] = transformer.train_logits(
            model, {"tokens": torch.from_numpy(toks), **tx})
        if cfg.family == "encdec":
            memory = transformer.encode(model, tx["enc_embeds"])
    t["prefill"], caches = prefill(
        model, {"tokens": torch.from_numpy(toks[:, :prompt]), **tx})
    t["prefill_cache"] = [{name: (c[name].clone() if name != "len"
                                  else c[name]) for name in c}
                          for c in caches]
    t["decode"] = []
    for i in range(gen):
        logits, caches = decode(
            model, caches, torch.from_numpy(toks[:, prompt + i:prompt + i + 1]),
            pos0 + i, memory)
        t["decode"].append(logits)
    t["decode_cache"] = caches
    return out


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(arch, prompt=S, gen=GEN, seed=0):
        key = (arch, prompt, gen, seed)
        if key not in cache:
            cache[key] = _run_both(arch, prompt, gen, seed)
        return cache[key]
    return get


def _assert_caches_equal(port, ref):
    """Each layer's cache fields: attention keys and values (bf16) and
    the tokens they hold, or a recurrent or xLSTM layer's states and conv
    history (fp32)."""
    assert len(port) == len(ref)
    for layer, (p, r) in enumerate(zip(port, ref)):
        assert set(p) == set(r), layer
        if "len" in p:
            assert p["len"] == int(r["len"]), layer
        for name in sorted(set(p) - {"len"}):
            dtype = torch.bfloat16 if "len" in p else torch.float32
            assert p[name].dtype == dtype, (layer, name)
            assert p[name].shape == r[name].shape, (layer, name)
            want = _as_f32(r[name])
            # the mLSTM's matrix memory sums a chunk's outer products k v^T
            # (entries up to a few hundred, with cancellation): a bf16
            # place of one k or v moves an entry by a place of the terms,
            # so it is held to TOL of the tensor's scale
            atol = TOL * float(np.abs(want).max()) if name == "S" else TOL
            np.testing.assert_allclose(_as_f32(p[name]), want,
                                       atol=atol, rtol=TOL,
                                       err_msg=f"layer {layer} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_reference(arch, runs):
    r = runs(arch)
    assert r["port"]["train"].shape == r["jax"]["train"].shape
    np.testing.assert_allclose(_as_f32(r["port"]["train"]),
                               _as_f32(r["jax"]["train"]), atol=TOL, rtol=0)
    # the MoE load-balance loss summed over the layers (0 without MoE)
    np.testing.assert_allclose(float(r["port"]["aux"]),
                               float(r["jax"]["aux"]), rtol=AUX_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, runs):
    r = runs(arch)
    np.testing.assert_allclose(_as_f32(r["port"]["prefill"]),
                               _as_f32(r["jax"]["prefill"]), atol=TOL,
                               rtol=0)
    _assert_caches_equal(r["port"]["prefill_cache"],
                         r["jax"]["prefill_cache"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, runs):
    r = runs(arch)
    for i, (p, j) in enumerate(zip(r["port"]["decode"], r["jax"]["decode"])):
        err = float(np.abs(_as_f32(p) - _as_f32(j)).max())
        assert err < TOL, (i, err)
    _assert_caches_equal(r["port"]["decode_cache"], r["jax"]["decode_cache"])


def test_windowed_cache_rolls_like_reference(runs):
    """danube smoke, window 32: a 40-token prompt leaves the last 32 keys
    in the ring, rotated so position p sits at slot p % 32, and 8 decode
    steps keep overwriting the oldest slot."""
    r = runs("h2o_danube_3_4b", prompt=40, gen=8, seed=3)
    cache = r["port"]["prefill_cache"][0]
    assert cache["k"].shape[1] == 32 and cache["len"] == 40
    _assert_caches_equal(r["port"]["prefill_cache"],
                         r["jax"]["prefill_cache"])
    for i, (p, j) in enumerate(zip(r["port"]["decode"], r["jax"]["decode"])):
        err = float(np.abs(_as_f32(p) - _as_f32(j)).max())
        assert err < TOL, (i, err)
    _assert_caches_equal(r["port"]["decode_cache"], r["jax"]["decode_cache"])


@pytest.mark.parametrize("n_layers", [4, 5])
def test_convert_orders_stacked_layers(n_layers):
    """gemma2's two-slot pattern (attn_local, attn): group g of slot i is
    layer 2g + i, and a fifth layer comes from the remainder list."""
    jcfg = dataclasses.replace(jconfigs.get("gemma2_27b", smoke=True),
                               n_layers=n_layers)
    cfg = dataclasses.replace(configs.get("gemma2_27b", smoke=True),
                              n_layers=n_layers)
    tree = jax.tree.map(np.asarray, jtransformer.init_params(
        jcfg, jax.random.PRNGKey(1), tp=1))
    sd = convert.params_from_numpy(cfg, tree)
    model = transformer.Transformer(cfg, generator=torch.Generator(),
                                    device=CPU)
    model.load_state_dict(sd)
    assert [b.attn.kind for b in model.blocks] == list(
        cfg.pattern_for(n_layers))
    for layer in range(n_layers):
        g, i = divmod(layer, 2)
        if g < n_layers // 2:
            want = tree["groups"][i]["attn"]["wq"][g]
        else:
            want = tree["rem"][i]["attn"]["wq"]
        np.testing.assert_array_equal(
            model.blocks[layer].attn.wq.numpy(), want)
    # every layer's weights differ, so a wrong order could not pass
    firsts = {model.blocks[layer].attn.wq.flatten()[0].item()
              for layer in range(n_layers)}
    assert len(firsts) == n_layers


def test_convert_orders_recurrentgemma_layers():
    """recurrentgemma's three-slot pattern (rglru, rglru, attn_local) at 5
    layers: group 0 is layers 0-2, and layers 3 and 4 are the remainder's
    two rglru layers (as layers 24 and 25 are at the published depth)."""
    jcfg = dataclasses.replace(jconfigs.get("recurrentgemma_2b", smoke=True),
                               n_layers=5)
    cfg = dataclasses.replace(configs.get("recurrentgemma_2b", smoke=True),
                              n_layers=5)
    tree = jax.tree.map(np.asarray, jtransformer.init_params(
        jcfg, jax.random.PRNGKey(2), tp=1))
    assert len(tree["rem"]) == 2 and all("rec" in r for r in tree["rem"])
    model = transformer.Transformer(cfg, generator=torch.Generator(),
                                    device=CPU)
    model.load_state_dict(convert.params_from_numpy(cfg, tree))
    assert [b.kind for b in model.blocks] == [
        "rglru", "rglru", "attn_local", "rglru", "rglru"]
    want = [tree["groups"][0]["rec"]["lam"][0],
            tree["groups"][1]["rec"]["lam"][0], None,
            tree["rem"][0]["rec"]["lam"], tree["rem"][1]["rec"]["lam"]]
    for layer, w in enumerate(want):
        if w is not None:
            np.testing.assert_array_equal(
                model.blocks[layer].rec.lam.numpy(), w)
    np.testing.assert_array_equal(model.blocks[2].attn.wq.numpy(),
                                  tree["groups"][2]["attn"]["wq"][0])
    np.testing.assert_array_equal(model.blocks[4].ffn.w_up.numpy(),
                                  tree["rem"][1]["ffn"]["w_up"])
    firsts = {model.blocks[layer].rec.w_x.flatten()[0].item()
              for layer in (0, 1, 3, 4)}
    assert len(firsts) == 4


def test_recurrentgemma_windowed_cache_rolls_like_reference(runs):
    """recurrentgemma smoke, window 32: a 40-token prompt leaves layer 2's
    (attn_local) ring holding the last 32 keys, and the recurrent layers'
    states and conv histories track the reference's through 8 decode
    steps."""
    r = runs("recurrentgemma_2b", prompt=40, gen=8, seed=3)
    cache = r["port"]["prefill_cache"][2]
    assert cache["k"].shape[1] == 32 and cache["len"] == 40
    assert r["port"]["prefill_cache"][0]["conv"].shape == (B, 3, 64)
    _assert_caches_equal(r["port"]["prefill_cache"],
                         r["jax"]["prefill_cache"])
    for i, (p, j) in enumerate(zip(r["port"]["decode"], r["jax"]["decode"])):
        err = float(np.abs(_as_f32(p) - _as_f32(j)).max())
        assert err < TOL, (i, err)
    _assert_caches_equal(r["port"]["decode_cache"], r["jax"]["decode_cache"])


def test_serve_recurrentgemma_end_to_end(capsys):
    """The port's counterpart of tests/test_system.py::
    test_serve_driver_end_to_end, on the recurrent model."""
    argv = ["--arch", "recurrentgemma-2b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "24", "--gen", "6"]
    first = serve.main(argv)
    second = serve.main(argv)
    assert first.shape == (2, 6)
    assert ((first >= 0) & (first < 256)).all()
    np.testing.assert_array_equal(first, second)
    assert "arch=recurrentgemma-smoke" in capsys.readouterr().out


@pytest.mark.parametrize("impl", ["kernel", "einsum"])
def test_serve_smoke_on_cpu_is_repeatable(impl, capsys):
    argv = ["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "12", "--gen", "5",
            "--impl", impl]
    first = serve.main(argv)
    second = serve.main(argv)
    assert first.shape == (2, 5)
    assert ((first >= 0) & (first < 256)).all()
    np.testing.assert_array_equal(first, second)
    assert "prefill:" in capsys.readouterr().out


def test_serve_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--smoke", "--gen", "2", "--prompt-len", "4"])


class _AnyStrategy(sharding.Strategy):
    """A Strategy that needs no mesh: the step factories check a
    strategy's type when they build a step (tests/test_torch_sharded_steps.py
    runs real ones)."""

    def __init__(self):
        pass


def test_steps_reject_unported_knobs():
    cfg = configs.get("phi4_mini_3_8b", smoke=True)
    with pytest.raises(TypeError, match="Strategy"):
        steps.make_prefill_step(cfg, strategy=object())
    with pytest.raises(TypeError, match="Strategy"):
        steps.make_decode_step(cfg, strategy=object())
    assert callable(steps.make_prefill_step(cfg, strategy=_AnyStrategy()))
    assert callable(steps.make_decode_step(cfg, strategy=_AnyStrategy()))
    with pytest.raises(ValueError, match="impl"):
        steps.make_decode_step(cfg, impl="pallas")


@pytest.mark.parametrize("arch", ["gemma2_27b", "h2o_danube_3_4b",
                                  "recurrentgemma_2b", *NEW_ARCHS])
def test_init_cache_matches_reference_shapes(arch):
    jcfg = jconfigs.get(arch, smoke=True)
    cfg = configs.get(arch, smoke=True)
    ref = _jax_layer_caches(jcfg, jtransformer.init_cache(jcfg, 3, 48))
    got = transformer.init_cache(cfg, 3, 48, device=CPU)
    assert len(got) == len(ref)
    for p, r in zip(got, ref):
        assert set(p) == set(r)
        for name in set(p) - {"len"}:
            assert p[name].shape == r[name].shape
            assert p[name].dtype == (torch.bfloat16 if "len" in p
                                     else torch.float32)
            assert not p[name].any()
        if "len" in p:
            assert p["len"] == int(r["len"]) == 0


@pytest.mark.parametrize("arch", [a.replace("_", "-") for a in NEW_ARCHS])
def test_serve_new_archs_on_cpu_are_repeatable(arch, capsys):
    """The serve CLI on the MoE, xLSTM, encoder-decoder and VLM smoke
    models: two runs give the same tokens."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "16", "--gen", "4"]
    first = serve.main(argv)
    second = serve.main(argv)
    assert first.shape == (2, 4)
    assert ((first >= 0) & (first < 256)).all()
    np.testing.assert_array_equal(first, second)
    assert "prefill:" in capsys.readouterr().out


def test_convert_orders_xlstm_layers():
    """xlstm's eight-slot pattern (seven mLSTM, one sLSTM) at 17 layers:
    group g of slot i is layer 8g + i, so layers 7 and 15 are the sLSTM
    slot's two groups, and layer 16 the remainder's one mLSTM layer (the
    published depth is 6 groups of 8)."""
    pattern = ("mlstm",) * 7 + ("slstm",)
    jcfg = dataclasses.replace(jconfigs.get("xlstm_1_3b", smoke=True),
                               block_pattern=pattern, n_layers=17)
    cfg = dataclasses.replace(configs.get("xlstm_1_3b", smoke=True),
                              block_pattern=pattern, n_layers=17)
    tree = jax.tree.map(np.asarray, jtransformer.init_params(
        jcfg, jax.random.PRNGKey(4), tp=1))
    assert len(tree["groups"]) == 8 and len(tree["rem"]) == 1
    model = transformer.Transformer(cfg, generator=torch.Generator(),
                                    device=CPU)
    model.load_state_dict(convert.params_from_numpy(cfg, tree))
    assert [b.kind for b in model.blocks] == list(pattern) * 2 + ["mlstm"]
    for layer in range(17):
        g, i = divmod(layer, 8)
        cell = tree["rem"][0] if g == 2 else jax.tree.map(
            lambda a: a[g], tree["groups"][i])
        name = "r_z" if i == 7 else "w_q"
        np.testing.assert_array_equal(
            getattr(model.blocks[layer].cell, name).numpy(),
            cell["cell"][name])
    firsts = {model.blocks[layer].cell.conv_w.flatten()[0].item()
              for layer in range(17)}
    assert len(firsts) == 17


def test_convert_carries_encoder_and_image_projection():
    """seamless's encoder (one slot stacked n_enc_layers deep), enc_ln
    and the decoder layers' cross-attention, and internvl2's img_proj."""
    for arch in ("seamless_m4t_large_v2", "internvl2_1b"):
        jcfg = jconfigs.get(arch, smoke=True)
        cfg = configs.get(arch, smoke=True)
        tree = jax.tree.map(np.asarray, jtransformer.init_params(
            jcfg, jax.random.PRNGKey(5), tp=1))
        model = transformer.Transformer(cfg, generator=torch.Generator(),
                                        device=CPU)
        model.load_state_dict(convert.params_from_numpy(cfg, tree))
        if cfg.family == "encdec":
            enc = tree["enc_groups"][0]
            assert len(model.enc_blocks) == cfg.n_enc_layers
            for g, block in enumerate(model.enc_blocks):
                np.testing.assert_array_equal(block.attn.wq.numpy(),
                                              enc["attn"]["wq"][g])
                np.testing.assert_array_equal(block.ffn.w_up.numpy(),
                                              enc["ffn"]["w_up"][g])
                assert not hasattr(block, "xattn")
            np.testing.assert_array_equal(model.enc_ln.numpy(),
                                          tree["enc_ln"])
            np.testing.assert_array_equal(model.blocks[1].xattn.wk.numpy(),
                                          tree["groups"][0]["xattn"]["wk"][1])
        else:
            np.testing.assert_array_equal(model.img_proj.numpy(),
                                          tree["img_proj"])


def test_unknown_block_kind_raises():
    cfg = dataclasses.replace(configs.get("phi4_mini_3_8b", smoke=True),
                              block_pattern=("mamba",))
    with pytest.raises(ValueError, match="block kinds"):
        transformer.Transformer(cfg, generator=torch.Generator(), device=CPU)
    with pytest.raises(ValueError, match="block kinds"):
        steps.make_prefill_step(cfg)


def test_encdec_decode_needs_memory():
    """The reference's decode step skips cross-attention when it is given
    no memory; the port refuses such a step instead."""
    cfg = configs.get("seamless_m4t_large_v2", smoke=True)
    model, inputs = serve.build(cfg, 2, 8, 0, CPU)
    _, caches = steps.make_prefill_step(cfg, max_len=12)(model, inputs)
    with pytest.raises(ValueError, match="memory"):
        steps.make_decode_step(cfg)(model, caches, inputs["tokens"][:, :1], 8)
