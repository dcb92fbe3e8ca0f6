"""The port's step factories under a sharding strategy, on gloo worlds of
CPU processes (tests/torch_ranks.py), against the reference and against
the port's own steps without one.

- A 4 x 2 ("data", "model") world, as the reference's
  tests/test_distributed.py::test_sharded_train_step_matches_single_device:
  phi4-mini smoke under "2d", batch (4, 64), parameters converted from
  the reference's init_params(PRNGKey(0), tp=2).  The loss is within
  5e-3 of the reference's single-device jitted step on the same
  parameters and batch (that test's bound), and within 1e-5 of the
  port's step without a strategy: a product that splits its summed dim
  over ranks adds the ranks' fp32 partial sums before its one rounding
  (models/common.py's matmul).  The grad norm is the global one (within
  NORM_RTOL of the one-rank step; a rank's own shards would give a
  fraction of it), and every parameter is equal on all 8 ranks.
- The same under "fsdp" on xlstm smoke, whose specs split more than half
  of its parameters (the reference's test_fsdp_strategy_shards_largest_dim).
  Its loss is within 5e-3 of the reference's and within XLSTM_ONE_RANK of
  the port's one-rank step: the mLSTM's fp32 products split over ranks
  sum in another order, which moves bf16 roundings after them (2e-4
  measured).
- Each gradient leaf (read from the first AdamW moments) within
  GRAD_TOL of its scale of the one-rank step's, as tests/test_torch_train
  holds the port's gradients to the reference's (XLSTM_GRAD_TOL for
  xlstm, for the reason above).
- A 1 x 2 world: a "2d" prefill and 4 greedy decode steps of phi4-mini
  smoke, logits within the model tests' TOL of the unsharded steps and
  the tokens identical; and recurrentgemma smoke at tp = 2, whose one kv
  head pads to 2, against the reference's prefill and a decode step at
  the same tp.
- A 1 x 4 world: qwen2-moe smoke at tp = 4, its 6 experts padded to 8
  (and its vocabulary to 512), against the reference at tp = 4.
- A 2 x 1 world: a prefill after a sharded train step reads the updated
  weights (the cached bf16 casts key on the parameters, and on a
  DTensor's own version, which its in-place ops count), bitwise a fresh
  model's; and, in one process, the cast cache against a gathered copy
  that gets the previous copy's storage and version.

The references run with XLA's `xla_allow_excess_precision` off, as in
tests/test_torch_model.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.runtime import steps as jsteps
from repro.train import optimizer as jopt
from repro_torch import configs, convert

import torch_ranks

STRICT = {"xla_allow_excess_precision": False}
# tests/test_distributed.py's bound on the sharded loss
REF_LOSS_TOL = 5e-3
ONE_RANK_LOSS_TOL = 1e-5
XLSTM_ONE_RANK = 1e-3
NORM_RTOL = 2e-2
# tests/test_torch_train.py's bound on a gradient leaf, of its scale;
# xlstm's under fsdp: its mLSTM's fp32 products split over ranks sum in
# another order and move the bf16 roundings after them (6.7e-2 measured
# on the embedding; with fp32 activations every leaf agrees to 1e-2)
GRAD_TOL = 5e-2
XLSTM_GRAD_TOL = 1e-1
# tests/test_torch_model.py's bound on logits
TOL = 2e-2
GEN = 4


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=STRICT)(*args)


def _ref_params(arch, tp):
    jcfg = jconfigs.get(arch, smoke=True)
    params = jtransformer.init_params(jcfg, jax.random.PRNGKey(0), tp=tp)
    return params, {k: v.numpy() for k, v in convert.params_from_numpy(
        configs.get(arch, smoke=True),
        jax.tree.map(np.asarray, params)).items()}


def _train_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (4, 64)).astype(np.int64),
            "labels": rng.integers(0, 256, (4, 64)).astype(np.int64)}


def _ref_train_loss(arch, params, batch):
    jcfg = jconfigs.get(arch, smoke=True)
    step = jsteps.make_train_step(jcfg, jopt.AdamWConfig(total_steps=10))
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    _, _, m = _strict(step, params, jopt.adamw_init(params), jb)
    return float(m["loss"])


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    refs, cases = {}, {}
    for name, arch, kind in (("phi4_2d", "phi4_mini_3_8b", "2d"),
                             ("xlstm_fsdp", "xlstm_1_3b", "fsdp")):
        params, state = _ref_params(arch, 2 if kind == "2d" else 1)
        batch = _train_batch()
        refs[name] = _ref_train_loss(arch, params, batch)
        cases[name] = dict(arch=arch, kind=kind, shape=(4, 2), state=state,
                           batch=batch, mode="train", plain=True)
    ranks = torch_ranks.run(8, torch_ranks.sharded_step_cases, cases,
                            tmp_path_factory.mktemp("world8"))
    return refs, ranks


@pytest.mark.parametrize("name", ["phi4_2d", "xlstm_fsdp"])
def test_sharded_train_step_matches_reference(world8, name):
    refs, ranks = world8
    loss = float(ranks[0][name]["sharded"]["metrics"]["loss"])
    assert abs(loss - refs[name]) < REF_LOSS_TOL, (loss, refs[name])


@pytest.mark.parametrize("name,tol", [("phi4_2d", ONE_RANK_LOSS_TOL),
                                      ("xlstm_fsdp", XLSTM_ONE_RANK)])
def test_sharded_train_step_matches_one_rank(world8, name, tol):
    _, ranks = world8
    got = ranks[0][name]
    sharded, plain = got["sharded"]["metrics"], got["plain"]["metrics"]
    assert abs(float(sharded["loss"]) - float(plain["loss"])) < tol
    norm, want = float(sharded["grad_norm"]), float(plain["grad_norm"])
    assert abs(norm - want) <= NORM_RTOL * want, (norm, want)
    assert int(sharded["step"]) == 1


@pytest.mark.parametrize("name", ["phi4_2d", "xlstm_fsdp"])
def test_sharded_parameters_equal_on_every_rank(world8, name):
    _, ranks = world8
    first = ranks[0][name]["sharded"]
    for r, res in enumerate(ranks):
        for part in ("params", "m"):
            for k, v in res[name]["sharded"][part].items():
                assert np.array_equal(v, first[part][k]), (r, part, k)
        for k, v in res[name]["sharded"]["metrics"].items():
            assert np.array_equal(v, first["metrics"][k]), (r, k)
    # the update moved every parameter by the one-rank step's amount
    plain = ranks[0][name]["plain"]["params"]
    for k, v in first["params"].items():
        assert np.abs(v - plain[k]).max() <= 1e-5, k


def _gate_weight(name: str) -> str | None:
    """The gate weight whose gradient scale holds an xLSTM gate bias (b_i
    of every cell, b_f of the mLSTM's), as tests/test_torch_train.py holds
    them; None for any other parameter."""
    head, _, leaf = name.rpartition(".")
    if leaf in ("b_i", "b_f") and ".cell." in f".{head}.":
        return f"{head}.w_{leaf[-1]}"
    return None


@pytest.mark.parametrize("name,tol", [("phi4_2d", GRAD_TOL),
                                      ("xlstm_fsdp", XLSTM_GRAD_TOL)])
def test_sharded_gradients_match_one_rank(world8, name, tol):
    """The first moments after one step are (1 - b1) times the clipped
    gradients: each leaf within `tol` of its scale of the one-rank
    step's (the bf16 backward's own noise), so no rank's part of a
    gradient is lost or counted twice (that would be off by a factor)."""
    _, ranks = world8
    got = ranks[0][name]["sharded"]["m"]
    want = ranks[0][name]["plain"]["m"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        ref = want.get(_gate_weight(k), v)
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(got[k] - v).max()) <= tol * scale, k


def test_fsdp_strategy_shards_most_parameters(world8):
    _, ranks = world8
    got = ranks[0]["xlstm_fsdp"]["sharded"]
    assert got["n_split"] > got["n_params"] // 2, got


def _serve_batch(arch, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (2, 16)).astype(np.int64)}


def _ref_serve(arch, params, batch, token):
    """The reference's prefill (impl="pallas") and one decode step fed
    `token` (B, 1)."""
    jcfg = jconfigs.get(arch, smoke=True)
    toks = jnp.asarray(batch["tokens"], jnp.int32)
    S = toks.shape[1]
    logits, caches = _strict(lambda p, t: jtransformer.prefill(
        jcfg, p, {"tokens": t}, impl="pallas", max_len=S + GEN), params,
        toks)
    step, _ = _strict(lambda p, c, t, pos: jtransformer.decode_step(
        jcfg, p, c, t, pos), params, caches,
        jnp.asarray(token, jnp.int32), jnp.asarray(S))
    return np.asarray(logits, np.float32), np.asarray(step, np.float32)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    _, phi4 = _ref_params("phi4_mini_3_8b", 2)
    rg_params, rg = _ref_params("recurrentgemma_2b", 2)
    cases = {
        "phi4": dict(arch="phi4_mini_3_8b", kind="2d", shape=(1, 2),
                     state=phi4, batch=_serve_batch("phi4_mini_3_8b"),
                     mode="serve", gen=GEN, plain=True),
        "recurrentgemma": dict(arch="recurrentgemma_2b", kind="2d",
                               shape=(1, 2), state=rg,
                               batch=_serve_batch("recurrentgemma_2b"),
                               mode="serve", gen=GEN)}
    ranks = torch_ranks.run(2, torch_ranks.sharded_step_cases, cases,
                            tmp_path_factory.mktemp("world2"))
    return {"recurrentgemma": rg_params}, cases, ranks


def test_sharded_prefill_and_decode_match_unsharded(world2):
    _, _, ranks = world2
    want = ranks[0]["phi4"]["plain"]
    for res in ranks:
        got = res["phi4"]["sharded"]
        np.testing.assert_allclose(got["prefill"], want["prefill"], atol=TOL,
                                   rtol=0)
        for a, b in zip(got["steps"], want["steps"]):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
        for a, b in zip(got["tokens"], want["tokens"]):
            np.testing.assert_array_equal(a, b)
        for layer, ref in zip(got["cache"], want["cache"]):
            for k in ref:
                np.testing.assert_allclose(layer[k], ref[k], atol=TOL,
                                           rtol=0)
    assert np.array_equal(ranks[0]["phi4"]["sharded"]["prefill"],
                          ranks[1]["phi4"]["sharded"]["prefill"])


def _check_padded_serve(arch, params, case, got):
    cfg = configs.get(arch, smoke=True)
    # the reference's decode step fed the port's first token
    logits, step = _ref_serve(arch, params, case["batch"],
                              got["prefill"].argmax(-1))
    assert got["prefill"].shape == logits.shape
    np.testing.assert_allclose(got["prefill"], logits, atol=TOL, rtol=0)
    np.testing.assert_allclose(got["steps"][0], step, atol=TOL, rtol=0)
    return cfg


def test_recurrentgemma_at_tp2_matches_reference(world2):
    refs, cases, ranks = world2
    cfg = configs.get("recurrentgemma_2b", smoke=True)
    assert cfg.padded_heads(2) == (4, 2) and cfg.n_kv_heads == 1
    got = ranks[0]["recurrentgemma"]["sharded"]
    _check_padded_serve("recurrentgemma_2b", refs["recurrentgemma"],
                        cases["recurrentgemma"], got)
    attn = [c for c in got["cache"] if "k" in c]
    assert attn and all(c["k"].shape[2] == 2 for c in attn)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    params, state = _ref_params("qwen2_moe_a2_7b", 4)
    case = dict(arch="qwen2_moe_a2_7b", kind="2d", shape=(1, 4),
                state=state, batch=_serve_batch("qwen2_moe_a2_7b"),
                mode="serve", gen=GEN)
    ranks = torch_ranks.run(4, torch_ranks.sharded_step_cases,
                            {"qwen2_moe": case},
                            tmp_path_factory.mktemp("world4"))
    return params, case, state, ranks


def test_qwen2_moe_at_tp4_matches_reference(world4):
    params, case, state, ranks = world4
    ep = [v.shape[0] for k, v in state.items() if k.endswith("ffn.w_gate")]
    assert ep and set(ep) == {8}            # 6 experts padded to 8
    got = ranks[0]["qwen2_moe"]["sharded"]
    _check_padded_serve("qwen2_moe_a2_7b", params, case, got)
    assert got["prefill"].shape[-1] == 512  # the vocabulary at tp = 4
    for res in ranks[1:]:
        assert np.array_equal(res["qwen2_moe"]["sharded"]["prefill"],
                              got["prefill"])


@pytest.mark.parametrize("arch,tp", [("recurrentgemma_2b", 2),
                                     ("qwen2_moe_a2_7b", 4)])
def test_reference_state_at_tp_fits_the_padded_model(arch, tp):
    """convert's parameters and AdamW state from the reference's
    init_params(tp=) tree load into the port's model at the same tp."""
    params, state = _ref_params(arch, tp)
    cfg, model = torch_ranks.smoke_model(arch, state, tp)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert shapes == {k: v.shape for k, v in state.items()}
    assert shapes != {k: tuple(p.shape) for k, p in
                      torch_ranks.smoke_model(arch, None)[1]
                      .named_parameters()}
    ostate = convert.opt_state_from_numpy(cfg, jax.tree.map(
        np.asarray, jopt.adamw_init(params)))
    for part in ("m", "v"):
        assert {k: tuple(v.shape) for k, v in ostate[part].items()} == shapes


def test_host_staging_sees_collectives_inside_dtensor_ops(tmp_path):
    """chip_smoke.py's host_staged mode passes DTensor ops on to DTensor,
    so the all-gathers that DTensor issues inside a product (and in
    full_tensor) come back to it: on the card it stages them through
    pinned host memory, since gloo's all_gather of CUDA tensors ends the
    process (and its all-to-all of them returns wrong data)."""
    ranks = torch_ranks.run(2, torch_ranks.staged_case, None, tmp_path)
    for res in ranks:
        assert res["equal"]
        assert res["seen"] and set(res["seen"]) == {
            "_c10d_functional.all_gather_into_tensor.default"}


def test_prefill_after_a_sharded_train_step_reads_the_new_weights(tmp_path):
    """A prefill under a strategy after an in-place AdamW update (an
    evaluation during training) reads the updated weights: the bf16
    casts it caches key on the model's parameters, not on the copies a
    step gathers, whose storage a later gather may get again.  Its logits
    are bitwise those of a fresh model loaded with the trained
    parameters."""
    ranks = torch_ranks.run(2, torch_ranks.eval_after_train_case,
                            _train_batch(), tmp_path)
    for res in ranks:
        assert not np.array_equal(res["after"], res["before"])
        np.testing.assert_array_equal(res["after"], res["fresh"])


def test_cast_cache_keys_on_the_parameter_not_its_gathered_copy():
    """A step's gathered copy of a weight may get the storage and the
    version count of the previous step's copy (a caching allocator hands
    the freed block out again): the bf16 cast cached from that copy is
    not read again once the parameter itself has changed."""
    from repro_torch.models import common as mcommon
    from repro_torch.runtime import steps as rsteps

    class Model(mcommon.CastWeights):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.randn(4, 4),
                                        requires_grad=False)

    buf = torch.empty(4, 4)

    class OneBlock:
        """A strategy whose every gather lands in the same block."""
        def gather_for_compute(self, model):
            t = torch.empty(0).set_(buf.untyped_storage(), 0, (4, 4))
            return {"w": t.copy_(model.w.detach())}

    model = Model()
    with rsteps._gathered(OneBlock(), model):
        first = model.w
        model.weight("w", torch.bfloat16)
    with torch.no_grad():
        model.w.add_(1.0)
    with rsteps._gathered(OneBlock(), model):
        again = model.w
        got = model.weight("w", torch.bfloat16)
    assert again.data_ptr() == first.data_ptr()
    assert again._version == first._version
    assert torch.equal(got, model.w.detach().to(torch.bfloat16))
    assert not model._sources
