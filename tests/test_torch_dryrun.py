"""The port's dry run (repro_torch.launch.dryrun) against the reference's
schema and counts.

One subprocess (tests/torch_ranks.py: dryrun_cases; it stands up worlds
on torch's "fake" backend, which no pytest worker should keep) runs the
CLI on phi4-mini's train_4k, decode_32k and long_500k cells and xlstm's
long_500k at 16 x 16, and counts one product on a 16 x 16 fake mesh.

- Every cell's JSON has the reference's CellResult fields; train_4k and
  decode_32k are ok, their params_total and params_active equal the
  reference's count_params on its init_params shapes at the strategy's
  tp (via jax.eval_shape), and train_4k reports all-gathers and
  reduce-scatters (the ZeRO-3 gather and its gradient's reduce-scatter).
- train_4k's flops a rank are within 10% of the model's count over 256
  ranks: 8 flops a weight a token through the layers (2 forward, 2 for
  the forward remat recomputes in the backward, 4 backward), 6 through
  the unembedding (outside the recomputed layers), and the einsum
  attention's S x S products (4 S^2 H hd a sequence and layer forward,
  4 times that in all).
- A product split over both mesh axes counts 1/256 of its global flops:
  the counter sees each rank's local product, not DTensor's global op.
- long_500k is skipped for phi4-mini (full attention) with the
  reference's message, and runs for xlstm.
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest

from repro import configs as jconfigs
from repro.models import transformer as jtransformer

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLOP_RTOL = 0.10


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    code = ("import json, sys, torch_ranks; "
            "json.dump(torch_ranks.dryrun_cases(sys.argv[1]), "
            "open(sys.argv[2], 'w'))")
    r = subprocess.run([sys.executable, "-c", code, str(tmp / "cells"),
                        str(tmp / "out.json")], env=env, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads((tmp / "out.json").read_text())


@functools.lru_cache(maxsize=None)
def _ref_dryrun():
    """The reference's dry-run module.  Importing it sets XLA_FLAGS to
    force 512 host devices; the flag is put back before any backend
    starts, so this process keeps its one device."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jdryrun


def _ref_counts(arch, tp):
    cfg = jconfigs.get(arch)
    shapes = jax.eval_shape(lambda: jtransformer.init_params(
        cfg, jax.random.PRNGKey(0), tp=tp))
    return list(_ref_dryrun().count_params(shapes, cfg))


@pytest.mark.parametrize("cell", ["phi4_mini_3_8b/train_4k",
                                  "phi4_mini_3_8b/decode_32k",
                                  "phi4_mini_3_8b/long_500k",
                                  "xlstm_1_3b/long_500k"])
def test_cells_have_the_reference_schema(dry, cell):
    fields = [f.name for f in dataclasses.fields(_ref_dryrun().CellResult)]
    got = dry["cells"][cell]
    assert list(got) == fields
    assert got["mesh"] == "16x16"


@pytest.mark.parametrize("cell,tp", [("phi4_mini_3_8b/train_4k", 1),
                                     ("phi4_mini_3_8b/decode_32k", 16)])
def test_cells_run_and_count_the_reference_params(dry, cell, tp):
    got = dry["cells"][cell]
    assert got["ok"], got["error"]
    arch = cell.split("/")[0]
    assert [got["params_total"], got["params_active"]] == \
        _ref_counts(arch, tp)
    assert got["flops_per_device"] > 0 and got["bytes_per_device"] > 0
    mem = got["memory"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["output_size_in_bytes"] > 0
    assert got["collectives"]["_counts"]


def test_train_cell_gathers_and_reduce_scatters(dry):
    coll = dry["cells"]["phi4_mini_3_8b/train_4k"]["collectives"]
    for kind in ("all-gather", "reduce-scatter"):
        assert coll["_counts"].get(kind, 0) > 0 and coll[kind] > 0, kind


def test_train_cell_flops_are_one_ranks_share(dry):
    got = dry["cells"]["phi4_mini_3_8b/train_4k"]
    cfg = jconfigs.get("phi4_mini_3_8b")
    assert got["tokens"] == 256 * 4096
    d, hq, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         cfg.d_ff)
    layer = 2 * d * hq * hd + 2 * d * hkv * hd + 3 * d * f
    S, T = 4096, got["tokens"]
    attention = 4 * (4 * S * S * hq * hd) * (T // S)
    want = (cfg.n_layers * (8 * layer * T + attention)
            + 6 * d * cfg.padded_vocab(1) * T) / 256
    assert abs(got["flops_per_device"] - want) <= FLOP_RTOL * want, \
        (got["flops_per_device"], want)


def test_split_product_counts_one_ranks_flops(dry):
    p = dry["product"]
    assert p["local_shape"] == [4096 // 16, 2048 // 16]
    assert p["flops"] * 256 == p["global"]
    assert not p["collectives"]


def test_split_product_is_counted_by_op_at_its_local_shapes(dry):
    """The per-op split names the local operands (a rank's rows of x, its
    columns of w) and adds up to the rank's flops."""
    p = dry["product"]
    assert p["by_op"] == {"aten.mm [256, 1024] [1024, 128]": p["flops"]}


def test_long_context_skips_full_attention(dry):
    phi4 = dry["cells"]["phi4_mini_3_8b/long_500k"]
    assert not phi4["ok"]
    assert phi4["error"] == ("skip: full-attention arch at 512k context "
                             "(see DESIGN.md §5)")
    xlstm = dry["cells"]["xlstm_1_3b/long_500k"]
    assert xlstm["ok"], xlstm["error"]
    assert xlstm["flops_per_device"] > 0
