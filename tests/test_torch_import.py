"""The port stands alone: no JAX, nothing of `repro`, explicit device.

`repro_torch` imports torch and numpy only, so it runs on a machine that
has no JAX; its entry points default to the card and raise when there is
none, rather than falling back to the CPU.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import solver, timeslot, topology, traffic

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "attention_tiles.py"]


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch, repro_torch.core.solver, "
            "repro_torch.kernels.ops, repro_torch.convert, "
            "repro_torch.models.transformer, repro_torch.runtime.steps, "
            "repro_torch.launch.serve, repro_torch.configs, "
            "repro_torch.core.oracle, repro_torch.sweep, "
            "repro_torch.sweep.__main__, repro_torch.core.failures, "
            "repro_torch.core.chaos, repro_torch.core.arrivals, "
            "repro_torch.core.fabric, repro_torch.core.heuristics, "
            "repro_torch.core.wavelength, repro_torch.core.policies, "
            "repro_torch.search, repro_torch.search.moves, "
            "repro_torch.search.optimize, repro_torch.service, "
            "repro_torch.service.clock, repro_torch.service.metrics, "
            "repro_torch.service.loop; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.stdout.strip() == "[]", out.stdout


def _imported_modules(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def _tiny_problem():
    topo = topology.build("pon3")
    cf = traffic.generate(topo, traffic.pattern(
        "uniform", n_map=2, n_reduce=2, total_gbits=4.0), 0)
    return timeslot.ScheduleProblem(topo, cf, n_slots=4, path_slack=2)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    p = _tiny_problem()
    with pytest.raises(RuntimeError, match="is_available"):
        solver.solve_fast(p, "energy")
    lp, _ = solver.build_routing_lp(p, "energy")
    with pytest.raises(RuntimeError, match="is_available"):
        solver.solve_lp(lp)


@pytest.mark.parametrize("kw,match", [
    pytest.param(dict(shards=2), "shards", id="kw1-shards"),
])
def test_unported_scale_knobs_raise(kw, match):
    p = _tiny_problem()
    with pytest.raises(NotImplementedError, match=match):
        solver.solve_fast(p, "energy", device="cpu", **kw)


def test_bf16_scale_knob_certifies():
    """precision="bf16" is ported: the tiny solve certifies."""
    from repro_torch.core import verify
    p = _tiny_problem()
    r = solver.solve_fast(p, "energy", iters=200, precision="bf16",
                          device="cpu")
    verify.check_schedule(p, r.schedule).assert_ok("bf16 tiny solve")
    assert r.metrics.feasible and r.remaining_gbits < 1e-6


def test_unknown_device_rejected():
    p = _tiny_problem()
    with pytest.raises(ValueError, match="device"):
        solver.solve_fast(p, "energy", device="meta")


def test_burst_wrapper_checks_operands():
    from repro_torch.kernels import ops, pdhg_spmv
    rng = np.random.default_rng(0)
    op = pdhg_spmv.ell_pack(rng.integers(0, 9, 30), rng.integers(0, 7, 30),
                            rng.normal(size=30), 9, 7)
    f = torch.zeros(op.n_pad)
    g = torch.zeros(op.m_pad)
    bn = torch.zeros(op.n_pad, dtype=torch.bool)
    bm = torch.zeros(op.m_pad, dtype=torch.bool)
    ell = (torch.from_numpy(op.rows.idx), torch.from_numpy(op.rows.val),
           torch.from_numpy(op.cols.idx), torch.from_numpy(op.cols.val))
    kw = dict(row_meta=op.rows.meta, col_meta=op.cols.meta, iters=3)
    ops.pdhg_burst(f, f, f, g, g, bm, bn, bm, *ell, f, g, **kw)
    with pytest.raises(ValueError, match="float32"):
        ops.pdhg_burst(f.double(), f, f, g, g, bm, bn, bm, *ell, f, g, **kw)
    with pytest.raises(ValueError, match="length"):
        ops.pdhg_burst(f[:-1], f, f, g, g, bm, bn, bm, *ell, f, g, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ops.pdhg_burst(f, f, f, g, g, bm, bn, bm, *ell,
                       torch.zeros(2 * op.n_pad)[::2], g, **kw)
