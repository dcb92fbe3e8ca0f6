"""The MLP's products under the "fsdp" strategy.

Under "fsdp" a batch splits its sequences over every rank, and
models/mlp.py pins each activation operand of the MLP's three products,
and the gradient that reaches it, to that layout (`shard`).  So every
product, forward and backward, takes a rank's own
tokens: no activation operand is whole on "model", which is what let a
torch release multiply a data row's sequences by the whole weight on
every rank of the row.

- On a 2 x 2 ("data", "model") gloo world of CPU processes
  (tests/torch_ranks.py), phi4-mini smoke's train step: the operands
  carry the pinned placements, and the step's numbers are what they were
  without the pins: the loss within 1e-5 and each gradient leaf within
  5e-2 of its scale of the same step without a strategy
  (tests/test_torch_sharded_steps.py's bounds), the same on every rank.
- At full width, in the dry run's phi4-mini x train_4k cell (a 16 x 16
  fake world in a subprocess, meta tensors): the same placements.  At
  the smoke widths DTensor's propagation keeps the tokens split with or
  without the pins; at full width, without them, the gate's gradient
  came back whole on "model" (this torch release then still counted a
  rank's flops, torch 2.11 did not).
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import torch_ranks

HERE = pathlib.Path(__file__).resolve().parent

ONE_RANK_LOSS_TOL = 1e-5
GRAD_TOL = 5e-2
WORLD = 4


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 256, (4, 64)).astype(np.int64),
             "labels": rng.integers(0, 256, (4, 64)).astype(np.int64)}
    return torch_ranks.run(WORLD, torch_ranks.mlp_layout_case,
                           {"batch": batch}, tmp_path_factory.mktemp("mlp4"))


@pytest.fixture(scope="module")
def dry_products(tmp_path_factory):
    """tests/torch_ranks.py's dryrun_mlp_products in a subprocess (the
    fake world is the process's one torch.distributed world)."""
    out = tmp_path_factory.mktemp("dry_mlp") / "products.json"
    code = ("import json, sys; sys.path.insert(0, sys.argv[2]); "
            "import torch_ranks; "
            "json.dump(torch_ranks.dryrun_mlp_products(), "
            "open(sys.argv[1], 'w'))")
    r = subprocess.run([sys.executable, "-c", code, str(out), str(HERE)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


def _check_tokens_split(seen, tokens, label):
    """Each record's activation operands (those with the token dim) are
    split on their token dim over both mesh dims."""
    for rec in seen:
        acts = [(shape, pl) for shape, pl in rec["operands"]
                if tokens in shape]
        assert acts, (label, rec)
        for shape, pl in acts:
            d = list(shape).index(tokens)
            assert pl == [f"Shard(dim={d})"] * 2, (label, rec)


@pytest.mark.parametrize("backward", [False, True])
def test_mlp_products_take_each_ranks_own_tokens(world4, backward):
    for rank, res in enumerate(world4):
        seen = [r for r in res["sharded"]["products"]
                if r["backward"] == backward]
        # smoke phi4: 2 layers, 3 products a layer forward; in the
        # backward each layer's recomputed products and their gradients
        assert len(seen) >= 6, (rank, len(seen))
        _check_tokens_split(seen, 4 * 64, f"rank {rank}")


@pytest.mark.parametrize("backward", [False, True])
def test_full_width_mlp_products_take_each_ranks_own_tokens(dry_products,
                                                            backward):
    seen = [r for r in dry_products if r["backward"] == backward]
    # phi4-mini: 32 layers, 3 products a layer forward
    assert len(seen) >= 3 * 32, len(seen)
    _check_tokens_split(seen, 256 * 4096, "train_4k")


def test_fsdp_step_matches_one_rank(world4):
    got, want = world4[0]["sharded"], world4[0]["plain"]
    assert abs(float(got["metrics"]["loss"]) - float(want["metrics"]["loss"])
               ) <= ONE_RANK_LOSS_TOL
    assert sorted(got["m"]) == sorted(want["m"])
    for k, v in want["m"].items():
        scale = max(float(np.abs(v).max()), 1e-30)
        assert float(np.abs(got["m"][k] - v).max()) <= GRAD_TOL * scale, k


def test_fsdp_step_is_the_same_on_every_rank(world4):
    first = world4[0]["sharded"]
    for res in world4[1:]:
        for k, v in res["sharded"]["metrics"].items():
            assert np.array_equal(v, first["metrics"][k]), k
        for k, v in res["sharded"]["m"].items():
            assert np.array_equal(v, first["m"][k]), k
