"""The port's training path against the reference's, on the CPU.

For the smoke configs of all ten architectures, the reference's
`init_params(PRNGKey(0))` goes through `convert.params_from_numpy` into
the port, both take the same batch (numpy seeds: tokens, labels with a
few -1 entries, and the encoder's frame embeddings or the VLM's image
embeddings), and the port's gradients of CE + AUX_WEIGHT * aux (in each
parameter's `.grad`, through `steps.compute_grads`) are held to
`jax.grad` of the reference's own loss, its gradient tree carried across
by `params_from_numpy`: the loss within 2e-2 absolute (as the logits in
tests/test_torch_model.py), the gradient's global norm within 2e-2 of
itself, and each gradient leaf within GRAD_TOL of that leaf's largest
magnitude.  The forward's bf16 activations differ between the packages
by a bf16 place here and there (the logits by up to 2e-2), and a
gradient leaf collects such differences over every token, so a leaf is
held to a share of its own scale rather than elementwise.  A full AdamW
step runs against the reference's from the same `opt_state_from_numpy`
state.  The reference is compiled with tests/test_torch_model.py's
STRICT options (every bf16 op rounded as written).

Within the port: microbatches=2 against 1 at the reference's own
tolerance (tests/test_microbatch.py), remat on and off bitwise equal,
and training through the kernels refused (they have no backward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro.runtime import steps as jsteps
from repro.train import optimizer as jopt
from repro_torch import configs, convert
from repro_torch.models import common, transformer
from repro_torch.runtime import sharding, steps
from repro_torch.train import optimizer as opt

ARCHS = ("phi4_mini_3_8b", "nemotron_4_15b", "gemma2_27b",
         "h2o_danube_3_4b", "recurrentgemma_2b", "granite_moe_1b_a400m",
         "qwen2_moe_a2_7b", "seamless_m4t_large_v2", "internvl2_1b",
         "xlstm_1_3b")
B, S, ENC = 2, 16, 12
LOSS_TOL = 2e-2
NORM_RTOL = 2e-2
# a gradient leaf against the reference's: max |port - ref| over the
# leaf's largest |ref|
GRAD_TOL = 5e-2
# xLSTM's gate biases are held to a share of their gate weight's
# gradient instead of their own.  Each bias gradient is the sum over every
# token of its gate's pre-activation cotangent, and the terms cancel.  A
# constant shift of an input gate's pre-activation scales the cell state
# and its normaliser alike, so h does not depend on b_i in exact
# arithmetic (the sLSTM's exactly, the mLSTM's up to its
# max(|n.q|, exp(-m)) floor): its gradient is 1e-9 (sLSTM, rounding
# alone) or 2e-4 to 3e-4 (mLSTM) against 0.1 to 0.6 for w_i.  The mLSTM's
# forget-gate bias (one a head) sums terms up to 2e-2 to 3e-3.  The
# terms themselves differ between the packages by a few per cent of their
# size (bf16 places of the forward), which a sum that cancels to a tenth
# of them turns into 10-200% of its own value; summing the reference's way
# (bf16 partial sums) does not bring the two closer.  So b_i (both kinds)
# and the mLSTM's b_f are held to GRAD_TOL of the gate weight's largest
# gradient, and b_i in both packages to NULL_SHARE of it.
NULL_SHARE = 1e-2
CPU = torch.device("cpu")
STRICT = {"xla_allow_excess_precision": False}


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


def _batch(cfg, seed, b=B, s=S):
    """numpy inputs: tokens, labels (a few -1), and the stub frontends'
    embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
           "labels": rng.integers(0, cfg.vocab_size, (b, s))}
    out["labels"][:, :2] = -1
    out = {k: v.astype(np.int32) for k, v in out.items()}
    if cfg.family == "encdec":
        out["enc_embeds"] = rng.standard_normal(
            (b, ENC, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["img_embeds"] = rng.standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return out


def _models(arch, seed=0):
    jcfg = jconfigs.get(arch, smoke=True)
    cfg = configs.get(arch, smoke=True)
    params = jtransformer.init_params(jcfg, jax.random.PRNGKey(seed), tp=1)
    model = transformer.Transformer(cfg, generator=torch.Generator(),
                                    device=CPU)
    model.load_state_dict(convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return jcfg, cfg, params, model


def _jax_loss(jcfg):
    def loss_fn(params, batch):
        logits, aux = jtransformer.train_logits(jcfg, params, batch,
                                                remat=False)
        loss = jcommon.cross_entropy(logits, batch["labels"],
                                     n_real_vocab=jcfg.vocab_size)
        return loss + jsteps.AUX_WEIGHT * aux, (loss, aux)
    return loss_fn


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaf_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    scale = float(want.abs().max())
    return float((got.float() - want).abs().max()) / max(scale, 1e-30)


def _gate_biases(model) -> list[str]:
    """The xLSTM gate biases held to their gate weight's gradient scale:
    b_i of every xLSTM cell and b_f of the mLSTM's."""
    out = []
    for i, block in enumerate(model.blocks):
        if block.kind in ("mlstm", "slstm"):
            out.append(f"blocks.{i}.cell.b_i")
        if block.kind == "mlstm":
            out.append(f"blocks.{i}.cell.b_f")
    return out


@pytest.mark.parametrize("final_cap", [0.0, 30.0])
def test_cross_entropy_matches_reference(final_cap):
    """Padded vocabulary (250 real of 384), -1 labels, a final softcap."""
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((3, 11, 384)) * 20).astype(np.float32)
    labels = rng.integers(0, 250, (3, 11)).astype(np.int32)
    labels[0, :4] = -1
    want = float(jcommon.cross_entropy(
        jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels),
        n_real_vocab=250, final_cap=final_cap))
    got = float(common.cross_entropy(
        torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels),
        n_real_vocab=250, final_cap=final_cap))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_cross_entropy_with_no_valid_label_is_zero():
    logits = torch.randn(2, 3, 128)
    labels = torch.full((2, 3), -1)
    assert float(common.cross_entropy(logits, labels, n_real_vocab=100)) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    jcfg, cfg, params, model = _models(arch)
    batch = _batch(cfg, seed=11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtotal, (jloss, jaux)), jgrads = _strict(
        jax.value_and_grad(_jax_loss(jcfg), has_aux=True), params, jb)
    want = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, jgrads))

    loss, aux = steps.compute_grads(cfg, model, _torch_batch(batch))
    assert abs(float(loss) - float(jloss)) < LOSS_TOL
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-3, atol=1e-6)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want)
    jnorm = float(jopt.global_norm(jgrads))
    norm = float(opt.global_norm(grads))
    assert abs(norm - jnorm) <= NORM_RTOL * jnorm, (norm, jnorm)
    gate_biases = _gate_biases(model)
    for k in gate_biases:
        scale = float(want[k.replace(".b_", ".w_")].abs().max())
        if k.endswith("b_i"):
            for g in (grads[k], want[k]):
                assert float(g.abs().max()) <= NULL_SHARE * scale, k
        assert float((grads[k] - want[k]).abs().max()) <= GRAD_TOL * scale, k
    errs = {k: _leaf_err(grads[k], want[k]) for k in want
            if k not in gate_biases}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    # the MoE router learns through the load-balance loss and the gates
    for k, g in grads.items():
        if k.endswith("ffn.router"):
            assert float(g.abs().max()) > 0, k


def test_train_step_matches_reference():
    """Two AdamW steps of both packages from the same weights: after the
    first (the reference's state carried across with
    opt_state_from_numpy, so the moments are not zero) the second step's
    parameters, moments and metrics agree."""
    arch = "granite_moe_1b_a400m"
    jcfg, cfg, params, model = _models(arch)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jocfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jocfg, remat=False)).lower(
        params, jopt.adamw_init(params),
        {k: jnp.asarray(v) for k, v in _batch(cfg, 0).items()}).compile(
            compiler_options=STRICT)
    params, jstate, _ = jstep(params, jopt.adamw_init(params),
                              {k: jnp.asarray(v)
                               for k, v in _batch(cfg, 0).items()})
    np_params = jax.tree.map(np.asarray, params)
    model.load_state_dict(convert.params_from_numpy(cfg, np_params))
    state = convert.opt_state_from_numpy(cfg,
                                         jax.tree.map(np.asarray, jstate))
    assert int(state["step"]) == 1 and state["step"].dtype == torch.int32

    batch = _batch(cfg, 1)
    params, jstate, jm = jstep(params, jstate,
                               {k: jnp.asarray(v) for k, v in batch.items()})
    step = steps.make_train_step(cfg, ocfg)
    model, state, m = step(model, state, _torch_batch(batch))
    assert int(m["step"]) == int(jm["step"]) == 2
    assert abs(float(m["loss"]) - float(jm["loss"])) < LOSS_TOL
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        NORM_RTOL * float(jm["grad_norm"])
    lr = float(opt.schedule(ocfg, torch.tensor(2)))
    want = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, params))
    wm = convert.opt_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate))
    for k, p in model.named_parameters():
        assert p.grad is None
        # an update is lr * (m^ / (sqrt(v^) + eps) + wd * p); Adam's
        # normalised step is within 1 of its sign, so two steps whose
        # gradients differ move a weight apart by at most ~2 lr
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   atol=2.5 * lr, rtol=0, err_msg=k)
        assert _leaf_err(state["m"][k], wm["m"][k]) <= GRAD_TOL, k
        assert _leaf_err(state["v"][k], wm["v"][k]) <= 2 * GRAD_TOL, k


def test_microbatch_matches_full_batch():
    """tests/test_microbatch.py for the port: phi4-mini smoke, batch 4 x
    64, one step with the batch in 2 microbatches against 1."""
    cfg = configs.get("phi4_mini_3_8b", smoke=True)
    ocfg = opt.AdamWConfig(total_steps=10)
    batch = _torch_batch(_batch(cfg, 5, b=4, s=64))
    out = []
    for n in (1, 2):
        model = transformer.Transformer(
            cfg, generator=torch.Generator().manual_seed(0), device=CPU)
        state = opt.adamw_init(dict(model.named_parameters()))
        step = steps.make_train_step(cfg, ocfg, microbatches=n)
        out.append(step(model, state, batch))
    (m1, _, r1), (m2, _, r2) = out
    assert abs(float(r1["loss"]) - float(r2["loss"])) < 1e-5
    for (k, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-5, rtol=2e-4, err_msg=k)


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "granite_moe_1b_a400m",
                                  "recurrentgemma_2b",
                                  "seamless_m4t_large_v2", "xlstm_1_3b"])
def test_remat_changes_no_number(arch):
    """Loss, aux and every gradient bitwise equal with and without remat;
    a MoE layer routes each token alike in the recomputed forward."""
    cfg = configs.get(arch, smoke=True)
    model = transformer.Transformer(
        cfg, generator=torch.Generator().manual_seed(3), device=CPU)
    batch = _torch_batch(_batch(cfg, 2))
    runs = []
    for remat in (True, False):
        loss, aux = steps.compute_grads(cfg, model, batch, remat=remat)
        runs.append((loss, aux, {k: p.grad.clone()
                                 for k, p in model.named_parameters()}))
    (l1, a1, g1), (l2, a2, g2) = runs
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


def test_train_step_moves_and_counts():
    cfg = configs.get("granite_moe_1b_a400m", smoke=True)
    model = transformer.Transformer(
        cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = opt.adamw_init(dict(model.named_parameters()))
    step = steps.make_train_step(cfg, opt.AdamWConfig(total_steps=10))
    batch = _torch_batch(_batch(cfg, 4))
    model, state, m = step(model, state, batch)
    assert int(state["step"]) == 1 and state["step"].dtype == torch.int32
    assert set(m) == {"loss", "aux_loss", "grad_norm", "step"}
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert float(m["aux_loss"]) > 0
    assert any(not torch.equal(before[k], p)
               for k, p in model.named_parameters())


def test_kernel_training_raises():
    """impl="kernel" has no backward: the step factory refuses it, and the
    kernels' wrappers raise under autograd instead of training on a zero
    gradient through attention and the scan."""
    cfg = configs.get("recurrentgemma_2b", smoke=True)
    with pytest.raises(ValueError, match="no backward"):
        steps.make_train_step(cfg, opt.AdamWConfig(), impl="kernel")
    model = transformer.Transformer(
        cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    batch = _torch_batch(_batch(cfg, 0))
    with pytest.raises(ValueError, match="no backward"):
        steps.compute_grads(cfg, model, batch, impl="kernel")
    model.requires_grad_(True)
    with pytest.raises(RuntimeError, match="rglru: .*no backward"):
        transformer.train_logits(model, batch, impl="kernel")
    cfg = configs.get("phi4_mini_3_8b", smoke=True)
    model = transformer.Transformer(
        cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    model.requires_grad_(True)
    with pytest.raises(RuntimeError, match="flash_attention: .*no backward"):
        transformer.train_logits(model, _torch_batch(_batch(cfg, 0)),
                                 impl="kernel")
    # serving (no grad) still goes through the kernels' plain versions
    with torch.no_grad():
        logits, _ = transformer.train_logits(
            model, _torch_batch(_batch(cfg, 0)), impl="kernel")
    assert logits.shape == (B, S, cfg.padded_vocab(1))


class _AnyStrategy(sharding.Strategy):
    """A Strategy that needs no mesh: make_train_step checks a strategy's
    type when it builds the step (tests/test_torch_sharded_steps.py runs
    real ones)."""

    def __init__(self):
        pass


def test_train_step_rejects_strategy():
    cfg = configs.get("phi4_mini_3_8b", smoke=True)
    with pytest.raises(TypeError, match="Strategy"):
        steps.make_train_step(cfg, opt.AdamWConfig(), strategy=object())
    assert callable(steps.make_train_step(cfg, opt.AdamWConfig(),
                                          strategy=_AnyStrategy()))


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "seamless_m4t_large_v2",
                                  "internvl2_1b"])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_synthetic_batch_shapes_match_reference(arch, mode):
    want = jsteps.synthetic_batch_shapes(jconfigs.get(arch), 2, 512,
                                         mode=mode, enc_len=64)
    got = steps.synthetic_batch_shapes(configs.get(arch), 2, 512, mode=mode,
                                       enc_len=64)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == w.shape
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype)
