"""A 1-rank world under a sharding strategy is the port without one, bit
for bit.

Each of the ten smoke configs, under both kinds ("2d" and "fsdp") on a
1 x 1 ("data", "model") gloo mesh of one CPU process
(tests/torch_ranks.py): an AdamW train step (metrics, every updated
parameter, the first moments) and a prefill with 3 greedy decode steps
(logits, caches, tokens) equal the same steps without a strategy.  Every
parameter, activation and cache is a DTensor there, each redistribution
a collective over one rank, and every op DTensor's.
"""
import numpy as np
import pytest

from repro_torch import configs

import torch_ranks

ARCHS = ("phi4_mini_3_8b", "nemotron_4_15b", "gemma2_27b",
         "h2o_danube_3_4b", "recurrentgemma_2b", "granite_moe_1b_a400m",
         "qwen2_moe_a2_7b", "seamless_m4t_large_v2", "internvl2_1b",
         "xlstm_1_3b")


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    cases = {}
    for arch in ARCHS:
        cfg = configs.get(arch, smoke=True)
        rng = np.random.default_rng(5)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8))}
        if cfg.family == "encdec":
            batch["enc_embeds"] = rng.standard_normal(
                (2, 6, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            batch["img_embeds"] = rng.standard_normal(
                (2, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
        train = dict(batch, labels=rng.integers(0, cfg.vocab_size, (2, 8)))
        for kind in ("2d", "fsdp"):
            base = dict(arch=arch, kind=kind, shape=(1, 1), state=None,
                        plain=True)
            cases[f"{arch}/{kind}/train"] = dict(base, batch=train,
                                                 mode="train")
            cases[f"{arch}/{kind}/serve"] = dict(base, batch=batch,
                                                 mode="serve", gen=3)
    (res,) = torch_ranks.run(1, torch_ranks.sharded_step_cases, cases,
                             tmp_path_factory.mktemp("world1"))
    return res


def _equal_trees(a, b, where=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _equal_trees(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{where}/{i}")
    else:
        assert np.array_equal(a, b), where


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_world_is_bitwise_no_strategy(world1, arch):
    for kind in ("2d", "fsdp"):
        for mode in ("train", "serve"):
            got = world1[f"{arch}/{kind}/{mode}"]
            plain = got["plain"]
            _equal_trees({k: got["sharded"][k] for k in plain}, plain,
                         f"{kind}/{mode}")
