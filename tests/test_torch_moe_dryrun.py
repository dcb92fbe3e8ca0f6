"""The dry run's MoE train cells and the MoE block's DTensor layout.

One subprocess (tests/torch_ranks.py: moe_dryrun_cases; it stands up
worlds on torch's "fake" backend, which no pytest worker should keep)
runs granite-moe and qwen2-moe x train_4k, each under "auto" (their
"2d") and under "fsdp", at 16 x 16 and full width, cut to 2 layers
inside the subprocess, and records every view the step asks of a
DTensor.

- Every cell is ok, counts all-gathers and reduce-scatters, and its
  flops a rank are within 10% of the MoE model's count over 256 ranks:
  8 flops a weight a token through the layers for the dense weights
  (attention, router, shared expert), 6 through the unembedding, the
  experts' three products at their capacity (groups x padded experts x
  C slots, not top-k tokens: the dispatch pads every expert's queue),
  the dispatch (3 products: forward, remat, the tokens' gradient; the
  dispatch tensor takes none) and the combine (4: its gradient reaches
  the gates) over groups x tokens x slots x d_model, and attention's
  S x S products as tests/test_torch_dryrun.py counts them.
- A gradient handed to the `shard` pin with a transposed shard (torch
  2.11's DTensor hands attention's so under "2d", and a view of it then
  fails on the shard) reaches x with a contiguous shard and the same
  values (a 1 x 1 gloo world in the same subprocess).
- The layout witness: no view in the step, forward, remat recompute or
  backward, merges a group of dims in which a dim other than the first
  is sharded.  torch 2.11's DTensor refuses those views, so this
  release (which lays them out) cannot show the fault by failing; the
  witness shows it by the views themselves.  Each cell's MoE blocks made
  views, so the witness saw them.
- The MoE layer, unsharded on the CPU, is bitwise the reference's three
  einsums (the form the port used before the bmm layout), forward and
  every gradient: at the smoke configs' top-2, and at the full configs'
  expert count and top-k (granite's 32 and 8, qwen2's 60 and 4) in bf16
  and in fp32.  fp32 shows the combine's summation order even at top-2
  (each term is a fused multiply-add onto the last), so the fp32 cases
  see a combine that sums a token's terms in another order than the
  einsum's.
"""
import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.models import common, moe, mlp

ROOT = pathlib.Path(__file__).resolve().parents[1]
# chip_smoke.py's phase 32(d) holds the same cells at full depth to the
# same count: one copy of it
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
FLOP_RTOL = 0.10
N_LAYERS = 2
CELLS = ("granite_moe_1b_a400m/auto", "granite_moe_1b_a400m/fsdp",
         "qwen2_moe_a2_7b/auto", "qwen2_moe_a2_7b/fsdp")


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    code = ("import json, sys, torch_ranks; "
            "out = torch_ranks.moe_dryrun_cases(int(sys.argv[1])); "
            "out['pinned'] = torch_ranks.pinned_gradient_case(sys.argv[3]); "
            "json.dump(out, open(sys.argv[2], 'w'))")
    r = subprocess.run([sys.executable, "-c", code, str(N_LAYERS),
                        str(tmp / "out.json"), str(tmp)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads((tmp / "out.json").read_text())


@pytest.mark.parametrize("cell", CELLS)
def test_moe_train_cell_runs(cells, cell):
    got = cells[cell]
    assert got["ok"], got["error"]
    assert got["tokens"] == 256 * 4096
    counts = got["collectives"]["_counts"]
    for kind in ("all-gather", "reduce-scatter"):
        assert counts.get(kind, 0) > 0, (kind, counts)


@pytest.mark.parametrize("cell", CELLS)
def test_moe_train_cell_flops_are_one_ranks_share(cells, cell):
    arch, strategy = cell.split("/")
    got = cells[cell]
    tp = 16 if strategy == "auto" else 1      # MoE train picks "2d"
    want = chip_smoke.moe_train_model_flops(arch, tp, 4096, 256 * 4096, 256,
                                            n_layers=N_LAYERS)
    assert abs(got["flops_per_device"] - want) <= FLOP_RTOL * want, \
        (got["flops_per_device"], want)


@pytest.mark.parametrize("cell", CELLS)
def test_no_view_flattens_a_split_dim_behind_the_first(cells, cell):
    got = cells[cell]
    assert got["views_in_moe"] > 0
    assert got["bad_views"] == []


def test_pinned_gradient_reaches_x_with_a_contiguous_shard(cells):
    """torch 2.11's DTensor hands attention's gradient under "2d" with a
    transposed shard, and a view of it then fails on the shard; the pin
    hands it on contiguous, with the same values."""
    got = cells["pinned"]
    assert not got["given_contiguous"]
    assert got["contiguous"] and got["equal"]


def _einsum_forward(layer, x):
    """The MoE layer as the reference writes it: three einsums."""
    B, S, D = x.shape
    dt = x.dtype
    xt = layer.groups(x)
    r = layer.route(xt)
    disp, comb = layer.dispatch(r, dt)
    xin = common.einsum("ngec,ngd->necd", disp, xt)
    gate = common.einsum("necd,edf->necf", xin, layer.weight("w_gate", dt))
    up = common.einsum("necd,edf->necf", xin, layer.weight("w_up", dt))
    y = common.einsum("necf,efd->necd", mlp.silu(gate) * up,
                      layer.weight("w_down", dt))
    out = common.einsum("ngec,necd->ngd", comb, y)
    if layer.cfg.moe.n_shared:
        sh = common.matmul(
            mlp.silu(common.matmul(xt, layer.weight("shared_gate", dt)))
            * common.matmul(xt, layer.weight("shared_up", dt)),
            layer.weight("shared_down", dt))
        mix = mlp.sigmoid(common.matmul(xt, layer.weight("shared_mix", dt)))
        out = out + mix * sh
    return out.reshape(B, S, D), r.aux


def _run(layer, forward, x):
    x = x.clone().requires_grad_()
    layer.zero_grad(set_to_none=True)
    out, aux = forward(layer, x)
    (out.float().square().sum() + aux).backward()
    return [out.detach(), aux.detach(), x.grad] + [
        p.grad for _, p in sorted(layer.named_parameters())]


def _assert_bitwise_the_einsum_form(cfg, dtype):
    g = torch.Generator().manual_seed(0)
    layer = moe.MoE(cfg, generator=g, device=torch.device("cpu"))
    x = torch.randn(2, 64, cfg.d_model, generator=g).to(dtype)
    got = _run(layer, moe.MoE.forward, x)
    want = _run(layer, _einsum_forward, x)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a is None and b is None) or torch.equal(a, b), i


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "qwen2_moe_a2_7b"])
def test_moe_layer_is_bitwise_the_einsum_form(arch):
    cfg = configs.get(arch, smoke=True)
    assert cfg.moe.top_k == 2
    _assert_bitwise_the_einsum_form(cfg, torch.bfloat16)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "qwen2_moe_a2_7b"])
def test_moe_layer_is_bitwise_the_einsum_form_at_full_top_k(arch, dtype):
    """The smoke width with the full config's experts and top-k."""
    full = configs.get(arch).moe
    assert full.top_k >= 4
    cfg = configs.get(arch, smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=full.n_experts, top_k=full.top_k))
    _assert_bitwise_the_einsum_form(cfg, getattr(torch, dtype))
