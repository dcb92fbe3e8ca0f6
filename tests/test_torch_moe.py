"""The port's MoE layer against the reference's, on the CPU.

The first layer's MoE of the granite-moe and qwen2-moe smoke configs
(weights from the reference's `init_params(PRNGKey(0))`, carried across
by `convert.params_from_numpy`) runs the same bf16 tokens (a numpy seed)
in both packages.  The reference is compiled with XLA's excess precision
off (tests/test_torch_model.py), and its routing is read off the same
compiled run: the router softmax where it reaches `jax.lax.top_k`, the
chosen experts it returns, and each (token, k)'s slot where it reaches
the slot one-hot (`jax.nn.one_hot(where(keep, pos, cap), cap + 1)`).

The routing must be bitwise the reference's: the chosen experts in
their order, each (token, k)'s slot, which pairs are kept, and the
expert counts.  The output is held within 2e-2 (bf16 activations, one
layer) and the load-balance loss within 1e-6 relative.  The cases: two
dispatch groups; a capacity factor so small that tokens are dropped; a
decode-sized batch of two tokens; and a router with exact ties (equal
columns), where `jax.lax.top_k` puts the lower expert first and a top-k
with ties to the higher expert must fail the same check.  The port's
index-built dispatch and combine tensors are held bitwise to the
reference's one-hot einsum form.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro_torch import configs, convert
from repro_torch.models import moe, transformer

ARCHS = ("granite_moe_1b_a400m", "qwen2_moe_a2_7b")
OUT_TOL = 2e-2
AUX_RTOL = 1e-6
PROBS_RTOL = 1e-6
STRICT = {"xla_allow_excess_precision": False}
CPU = torch.device("cpu")


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


def _layers(arch, capacity_factor=None, tie=()):
    """(reference config, the reference's first-layer MoE params, the
    port's MoE) on the same weights.  `tie`: router columns made equal
    to the first one's, doubled, so those experts tie and lead."""
    jcfg = jconfigs.get(arch, smoke=True)
    cfg = configs.get(arch, smoke=True)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    tree = jax.tree.map(np.asarray, jtransformer.init_params(
        jcfg, jax.random.PRNGKey(0), tp=1))
    p = {name: np.array(leaf[0]) for name, leaf in
         tree["groups"][0]["ffn"].items()}
    if tie:
        lead = 2 * p["router"][:, tie[0]]
        for e in tie:
            p["router"][:, e] = lead
    layer = moe.MoE(cfg, generator=torch.Generator(), device=CPU)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    return jcfg, {k: jnp.asarray(v) for k, v in p.items()}, layer


def _tokens(seed, B, S, d):
    x = np.random.default_rng(seed).standard_normal((B, S, d))
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _reference(jcfg, params, x):
    """The reference's (out, aux, probs, topi, slot-or-cap (n, g, K)),
    all from one compiled run of `moe.run`."""
    seen = {}
    real_top_k, real_one_hot = jax.lax.top_k, jax.nn.one_hot

    def top_k(probs, k):
        seen["probs"] = probs
        seen["topv"], seen["topi"] = real_top_k(probs, k)
        return seen["topv"], seen["topi"]

    def one_hot(a, num_classes, **kw):
        if kw.get("dtype") != jnp.int32:          # the slot one-hot
            seen["pos"] = a
        return real_one_hot(a, num_classes, **kw)

    def run(p, xj):
        with mock.patch.object(jax.lax, "top_k", top_k), \
                mock.patch.object(jax.nn, "one_hot", one_hot):
            out, aux = jmoe.run(p, xj, jcfg)
        topi = seen["topi"]
        slot = jnp.take_along_axis(seen["pos"], topi[..., None], -1)[..., 0]
        return out, aux, seen["probs"], topi, slot

    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return [np.asarray(jnp.asarray(a, jnp.float32)) if a.dtype == jnp.bfloat16
            else np.asarray(a) for a in _strict(run, params, xj)]


def _compare(jcfg, params, layer, x):
    """Routing bitwise, output and aux within tolerance; returns the
    port's routing."""
    out, aux, probs, topi, slot = _reference(jcfg, params, x)
    with torch.no_grad():
        r = layer.route(layer.groups(x))
        got, got_aux = layer(x)
    np.testing.assert_allclose(r.probs.numpy(), probs, rtol=PROBS_RTOL,
                               atol=0)
    np.testing.assert_array_equal(r.topi.numpy(), topi)
    np.testing.assert_array_equal(
        torch.where(r.keep, r.slot, r.cap).numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), slot < r.cap)
    assert r.counts.dtype == torch.int64
    np.testing.assert_array_equal(
        r.counts.numpy(), np.bincount(topi.ravel(),
                                      minlength=layer.router.shape[1]))
    np.testing.assert_allclose(got.float().numpy(), out, atol=OUT_TOL,
                               rtol=0)
    np.testing.assert_allclose(float(got_aux), float(aux), rtol=AUX_RTOL)
    return r


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_reference(arch):
    """Two dispatch groups of 64 tokens (B*S = 128, group_size 64)."""
    jcfg, params, layer = _layers(arch)
    r = _compare(jcfg, params, layer, _tokens(1, 4, 32, jcfg.d_model))
    assert r.topi.shape[:2] == (2, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_drops_tokens_past_capacity_like_reference(arch):
    """capacity_factor 0.25: a quarter of an expert's even share of a
    group's 128 choices (4 slots of 16 with 8 experts, 6 of 22 with 6),
    so most pairs are dropped, the same ones as the reference's."""
    jcfg, params, layer = _layers(arch, capacity_factor=0.25)
    r = _compare(jcfg, params, layer, _tokens(2, 4, 32, jcfg.d_model))
    assert r.cap < 64 * jcfg.moe.top_k / jcfg.moe.n_experts
    assert 0 < int(r.keep.sum()) < r.keep.numel() // 2


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_batch_matches_reference(arch):
    """Two tokens, as a decode step routes them: one group of 2, and a
    capacity of top_k slots."""
    jcfg, params, layer = _layers(arch)
    r = _compare(jcfg, params, layer, _tokens(3, 2, 1, jcfg.d_model))
    assert r.topi.shape[:2] == (1, 2) and r.cap == jcfg.moe.top_k


def _reversed_ties_top_k(probs, k):
    """A top-k whose ties go to the higher index: torch.topk over the
    experts in reverse order (a stable sort there, so the tie order is
    certain), mapped back."""
    E = probs.shape[-1]
    values, indices = torch.sort(probs.flip(-1), dim=-1, descending=True,
                                 stable=True)
    return values[..., :k], (E - 1 - indices)[..., :k]


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ties_go_to_the_lower_expert(arch, monkeypatch):
    """Router columns 1, 3 and 4 equal (and doubled, so they lead): every
    token's probabilities tie exactly there, top-2 takes experts 1 and 3
    in that order, as jax.lax.top_k does.  With ties to the higher expert
    instead, the check fails."""
    jcfg, params, layer = _layers(arch, tie=(1, 3, 4))
    x = _tokens(4, 4, 32, jcfg.d_model)
    r = _compare(jcfg, params, layer, x)
    assert torch.equal(r.probs[..., 1], r.probs[..., 3])
    led = (r.topi[..., 0] == 1) & (r.topi[..., 1] == 3)
    assert int(led.sum()) > 0
    monkeypatch.setattr(moe, "top_k", _reversed_ties_top_k)
    with pytest.raises(AssertionError):
        _compare(jcfg, params, layer, x)


def test_top_k_order_matches_jax_on_ties():
    """Values from a set of five, so most rows tie: the same values and
    indices as jax.lax.top_k, lower index first among equals."""
    rng = np.random.default_rng(5)
    probs = rng.choice(np.float32([0.0, 0.1, 0.2, 0.25, 0.45]), (64, 12))
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 5)
    got_v, got_i = moe.top_k(torch.from_numpy(probs), 5)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("capacity_factor", [None, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_by_index_equals_onehot_einsum(arch, capacity_factor):
    """The dispatch and combine tensors written by index are bitwise the
    reference's one-hot einsum form, with and without dropped tokens."""
    _, _, layer = _layers(arch, capacity_factor=capacity_factor)
    x = _tokens(6, 4, 32, layer.cfg.d_model)
    with torch.no_grad():
        r = layer.route(layer.groups(x))
        disp, comb = layer.dispatch(r, torch.bfloat16)
        want_disp, want_comb = layer.dispatch_onehot(r, torch.bfloat16)
    assert disp.shape == (2, 64, layer.router.shape[1], r.cap)
    assert torch.equal(disp, want_disp) and torch.equal(comb, want_comb)
    # one token a slot, and each kept (token, k) pair in one slot
    assert int(disp.sum(dim=1).max()) <= 1
    assert int(disp.sum()) == int(r.keep.sum())


def test_moe_in_the_model_sums_aux_over_layers():
    """train_logits returns the layers' aux losses summed (the
    reference's _run_stack): two MoE layers, each within 1e-6 of the
    layer run alone on its own input."""
    cfg = configs.get("granite_moe_1b_a400m", smoke=True)
    model = transformer.Transformer(cfg, generator=torch.Generator()
                                    .manual_seed(0), device=CPU)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 16)))
    seen = []
    real = moe.MoE.forward

    def record(self, x):
        out, aux = real(self, x)
        seen.append(float(aux))
        return out, aux

    with torch.no_grad(), mock.patch.object(moe.MoE, "forward", record):
        _, aux = transformer.train_logits(model, {"tokens": toks})
    assert len(seen) == cfg.n_layers
    assert float(aux) == pytest.approx(sum(seen), rel=1e-6)


def test_convert_carries_moe_weights():
    """granite's `ffn` tree (router and stacked experts) and qwen2's
    shared expert land in each layer's MoE."""
    for arch in ARCHS:
        jcfg = jconfigs.get(arch, smoke=True)
        cfg = configs.get(arch, smoke=True)
        tree = jax.tree.map(np.asarray, jtransformer.init_params(
            jcfg, jax.random.PRNGKey(3), tp=1))
        model = transformer.Transformer(cfg, generator=torch.Generator(),
                                        device=CPU)
        model.load_state_dict(convert.params_from_numpy(cfg, tree))
        ffn = tree["groups"][0]["ffn"]
        for layer in range(cfg.n_layers):
            got = model.blocks[layer].ffn
            assert isinstance(got, moe.MoE)
            for name, stacked in ffn.items():
                np.testing.assert_array_equal(getattr(got, name).numpy(),
                                              stacked[layer])
        assert ("shared_mix" in ffn) == bool(cfg.moe.n_shared)
