"""The port's sharding strategies (runtime/sharding.py) against the
reference's, spec for spec.

For the ten configs at full size, both kinds ("2d", "fsdp"), three
meshes (4 x 2, 16 x 16, and 2 x 16 x 16 across pods) and sp off and on:
every parameter's param_spec and compute_spec, every decode cache's
cache_spec, the synthetic batches' batch_spec, and logical_to_spec of
each logical-axes tuple the models pass to `shard`, at the shapes the
strategy's padded widths give.  The reference's Strategy reads only its
mesh's `.shape`, so it runs on a stand-in holding the axis sizes; the
port's runs on torch DeviceMeshes in one subprocess that stands up a
world of as many ranks on the "fake" backend (no pytest worker keeps a
process group), its models on the meta device.  The reference's specs
of stacked layers lose their leading None for the group dim (the port's
layers are a ModuleList); its stacked parameters map to the port's
layers as convert.params_from_numpy maps them.  The padded shapes and
the dry run's count_params must equal the reference's exactly.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.runtime import sharding as jsharding
from repro.runtime import steps as jsteps

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("phi4_mini_3_8b", "nemotron_4_15b", "gemma2_27b",
         "h2o_danube_3_4b", "granite_moe_1b_a400m", "qwen2_moe_a2_7b",
         "recurrentgemma_2b", "seamless_m4t_large_v2", "internvl2_1b",
         "xlstm_1_3b")
KINDS = ("2d", "fsdp")
MESHES = {"4x2": ({"data": 4, "model": 2}, False),
          "16x16": ({"data": 16, "model": 16}, False),
          "2x16x16": ({"pod": 2, "data": 16, "model": 16}, True)}
SP = (False, True)
# the synthetic batches' sizes (divisible by every batch mesh, by some,
# by none) and the caches' (batch, max_len)
BATCHES = (512, 32, 6)
CACHE = (32, 64)


class _Mesh:
    """What the reference's Strategy reads of a jax Mesh: `.shape`, the
    axis sizes by name."""

    def __init__(self, shape):
        self.shape = shape


def _ref_strategy(mesh, kind, sp):
    sizes, multi_pod = MESHES[mesh]
    return jsharding.Strategy(_Mesh(sizes), kind, multi_pod, sp=sp)


def _spec(p) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in p]


def _queries(cfg, tp):
    """(logical axes, shape) of each activation the models pass to
    `shard` (and the MoE's routing layout), at batch sizes 512, 6 and 1
    and sequence lengths 4096 and 6."""
    hq, hkv = cfg.padded_heads(tp)
    vp, d, hd = cfg.padded_vocab(tp), cfg.d_model, cfg.hd
    f = cfg.d_ff or 2 * d
    ep = jmoe.padded_experts(cfg.moe, tp) if cfg.moe else 64
    out = []
    for b in (512, 6, 1):
        for s in (4096, 6):
            out += [(("batch", None, "heads", None), (b, s, hq, hd)),
                    (("batch", None, "kv_heads", None), (b, s, hkv, hd)),
                    (("batch", "seq", "embed"), (b, s, d)),
                    (("batch", None, "mlp"), (b, s, f)),
                    (("batch", None, "vocab"), (b, s, vp)),
                    (("batch", None, "experts", None), (b, s, ep, 8)),
                    (("batch", "experts", None, None), (b, ep, 8, d)),
                    (("batch", None, None), (b, s, ep))]
    return out


def _tp(mesh, kind):
    return MESHES[mesh][0]["model"] if kind == "2d" else 1


@pytest.fixture(scope="module")
def port_specs(tmp_path_factory):
    """strategy_specs (tests/torch_ranks.py) in a subprocess."""
    queries = {m: {k: {a: _queries(jconfigs.get(a), _tp(m, k))
                       for a in ARCHS} for k in KINDS} for m in MESHES}
    payload = dict(archs=ARCHS, kinds=KINDS, sp=SP, batches=BATCHES,
                   cache=CACHE, queries=queries)
    tmp = tmp_path_factory.mktemp("specs")
    (tmp / "payload.json").write_text(json.dumps(payload))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    code = ("import json, sys, torch_ranks; p = json.load(open(sys.argv[1]));"
            " json.dump(torch_ranks.strategy_specs(p), open(sys.argv[2], 'w'))")
    r = subprocess.run([sys.executable, "-c", code, str(tmp / "payload.json"),
                        str(tmp / "specs.json")], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads((tmp / "specs.json").read_text())


@functools.lru_cache(maxsize=None)
def _ref_params(arch, tp):
    return jtransformer.init_params(jconfigs.get(arch), shapes_only=True,
                                    tp=tp)


def _layer_names(cfg, path):
    """The port's parameter (or cache) names of a reference tree path
    (without the leaf's own name): a stacked slot's path names every
    layer it holds."""
    keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
    P = len(cfg.block_pattern)
    n_groups = cfg.n_layers // P
    if keys[0] == "groups":
        return [f"blocks.{g * P + keys[1]}" for g in range(n_groups)], \
            keys[2:], True
    if keys[0] == "rem":
        return [f"blocks.{n_groups * P + keys[1]}"], keys[2:], False
    if keys[0] == "enc_groups":
        return [f"enc_blocks.{g}" for g in range(cfg.n_enc_layers)], \
            keys[2:], True
    return [""], keys, False


def _ref_param_specs(arch, mesh, kind, sp):
    """name -> (core shape, param_spec, compute_spec) of the reference,
    keyed by the port's parameter names."""
    import jax
    cfg = jconfigs.get(arch)
    st = _ref_strategy(mesh, kind, sp)
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            _ref_params(arch, st.tp)):
        layers, rest, stacked = _layer_names(cfg, path)
        spec = _spec(st.param_spec(path, leaf))
        comp = _spec(st.compute_spec(path, leaf))
        shape = list(leaf.shape)
        if stacked:
            assert spec[0] is None and comp[0] is None
            spec, comp, shape = spec[1:], comp[1:], shape[1:]
        for layer in layers:
            name = ".".join([layer] + [str(k) for k in rest]).lstrip(".")
            out[name] = [shape, spec, comp]
    return out


def _case(port_specs, mesh, kind, sp, arch):
    return port_specs[f"{mesh}/{kind}/{sp}/{arch}"]


CASES = [(m, k, sp, a) for m in MESHES for k in KINDS for sp in SP
         for a in ARCHS]


@pytest.mark.parametrize("mesh,kind,sp,arch", CASES)
def test_param_and_compute_specs_match_reference(port_specs, mesh, kind, sp,
                                                 arch):
    got = _case(port_specs, mesh, kind, sp, arch)
    want = _ref_param_specs(arch, mesh, kind, sp)
    assert got["tp"] == _ref_strategy(mesh, kind, sp).tp
    assert sorted(got["params"]) == sorted(want)
    for name, (shape, spec, comp) in want.items():
        assert got["params"][name] == [shape, spec, comp], name


@pytest.mark.parametrize("mesh,kind,sp,arch", CASES)
def test_cache_batch_and_logical_specs_match_reference(port_specs, mesh,
                                                       kind, sp, arch):
    import jax
    cfg = jconfigs.get(arch)
    st = _ref_strategy(mesh, kind, sp)
    got = _case(port_specs, mesh, kind, sp, arch)
    caches = jtransformer.init_cache(cfg, *CACHE, tp=st.tp,
                                     shapes_only=True)
    specs = st.cache_spec(caches)
    want = {}
    for (path, leaf), (_, spec) in zip(
            jax.tree_util.tree_leaves_with_path(caches),
            jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda s: isinstance(s, jax.sharding
                                                    .PartitionSpec))):
        layers, rest, stacked = _layer_names(cfg, path)
        shape, spec = list(leaf.shape), _spec(spec)
        if stacked:
            shape, spec = shape[1:], spec[1:]
        if rest[-1] == "len":       # the port's is a Python int
            continue
        for layer in layers:
            want[f"{layer}.{rest[-1]}"] = [shape, spec]
    flat = {f"blocks.{i}.{k}": v for i, layer in enumerate(got["caches"])
            for k, v in layer.items()}
    assert flat == want
    for b in BATCHES:
        for mode in ("train", "prefill"):
            batch = jsteps.synthetic_batch_shapes(cfg, b, 4096, mode=mode,
                                                  enc_len=16)
            assert got["batch"][f"{mode}/{b}"] == {
                k: _spec(v) for k, v in st.batch_spec(batch).items()}
    assert got["logical"] == [_spec(st.logical_to_spec(a, s))
                              for a, s in _queries(cfg, st.tp)]


def _ref_count_params(arch, tp):
    """The reference dry run's count_params.  Importing repro.launch.dryrun
    sets XLA_FLAGS to force 512 host devices; the flag is put back before
    any backend starts, so this process keeps its one device."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return list(jdryrun.count_params(_ref_params(arch, tp),
                                     jconfigs.get(arch)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh,kind", [("4x2", "2d"), ("16x16", "2d"),
                                       ("16x16", "fsdp")])
def test_padded_shapes_and_param_counts_match_reference(port_specs, arch,
                                                        mesh, kind):
    got = _case(port_specs, mesh, kind, False, arch)
    tp = got["tp"]
    want = _ref_param_specs(arch, mesh, kind, False)
    assert {n: v[0] for n, v in got["params"].items()} == \
        {n: v[0] for n, v in want.items()}
    assert got["count"] == _ref_count_params(arch, tp)
